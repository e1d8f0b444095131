"""Scene assets built from a seed inside the checkout.

The reference ships MagicaVoxel models (crates, a glass test box, the enemy
drone).  This package carries none of them: `asset_path` writes seeded
procedural stand-ins as real `.vox` files under ``<checkout>/.assets/vox``
on first use, so every loader path (`load_vox`, `VoxelVolume.from_vox`)
runs on files that exist wherever the checkout does.

Material ids follow the reference's palette rows: 1-8 glass, 9-16 mirror,
above 16 diffuse.  The glass box uses glass id 4 and mirror id 12.
"""

from __future__ import annotations

import os

import numpy as np

from voxel_tracer_tpu.models.vox import encode_vox

ASSET_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".assets", "vox")

GLASS_ID = 4
MIRROR_ID = 12


def procedural_crate(n: int = 32, mat: int = 30) -> np.ndarray:
    """Crate-ish hollow box with edge beams and two planked faces."""
    g = np.zeros((n, n, n), np.uint8)
    g[:2], g[-2:] = mat, mat
    g[:, :2], g[:, -2:] = mat, mat
    g[:, :, :2], g[:, :, -2:] = mat, mat
    g[2:-2, 2:-2, 2:-2] = 0
    g[2, 2:-2, 2:-2] = mat + 1
    g[-3, 2:-2, 2:-2] = mat + 1
    return g


def procedural_glass_box(seed: int = 0) -> np.ndarray:
    """Glass test box (32 x 24 x 32, Z Y X): diffuse floor, hollow glass
    cube (id 4) around a diffuse pillar, mirror wall (id 12) behind it."""
    rng = np.random.RandomState(seed)
    g = np.zeros((32, 24, 32), np.uint8)
    g[:, 0:2, :] = 30 + rng.randint(0, 3, (32, 2, 32))    # speckled floor
    g[6:26, 2:18, 6:26] = GLASS_ID
    g[7:25, 3:17, 7:25] = 0                                # hollow it out
    g[13:19, 2:12, 13:19] = 40                             # pillar inside
    g[28:30, 2:20, 2:30] = MIRROR_ID
    return g


def procedural_drone(seed: int = 1) -> np.ndarray:
    """Enemy drone (12 x 8 x 12): ellipsoid body, four rotor arms, eye."""
    rng = np.random.RandomState(seed)
    z, y, x = np.meshgrid(np.arange(12), np.arange(8), np.arange(12),
                          indexing="ij")
    r2 = ((x - 5.5) / 4.0) ** 2 + ((y - 3.5) / 2.5) ** 2 + ((z - 5.5) / 4.0) ** 2
    g = np.where(r2 < 1.0, 50 + rng.randint(0, 2, r2.shape), 0).astype(np.uint8)
    for cz, cx in ((1, 1), (1, 10), (10, 1), (10, 10)):
        g[cz - 1:cz + 1, 5:7, cx - 1:cx + 1] = 60
    g[2:4, 3:5, 5:7] = 70
    return g


def procedural_palette(seed: int = 0) -> np.ndarray:
    """(256, 4) RGBA palette: seeded colors, fixed tints for the ids the
    procedural models use, index 0 transparent."""
    rng = np.random.RandomState(seed)
    pal = np.concatenate([rng.randint(40, 230, (256, 3)),
                          np.full((256, 1), 255)], axis=1).astype(np.uint8)
    pal[0] = 0
    pal[GLASS_ID] = (200, 230, 255, 255)
    pal[MIRROR_ID] = (220, 220, 220, 255)
    pal[30:33] = ((150, 105, 60, 255), (170, 120, 70, 255), (130, 90, 50, 255))
    pal[40] = (200, 60, 50, 255)
    return pal


_MODELS = {
    "crate-16.vox": lambda: procedural_crate(32, 30),
    "crate-10.vox": lambda: procedural_crate(32, 40),
    "testing/glass-box.vox": procedural_glass_box,
    "enemy-drone.vox": procedural_drone,
}
ASSET_NAMES = tuple(_MODELS)


def asset_path(name: str) -> str:
    """Path of the named `.vox` asset, written on first use."""
    if name not in _MODELS:
        raise KeyError(f"unknown asset {name!r}; known: {ASSET_NAMES}")
    path = os.path.join(ASSET_ROOT, name)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(encode_vox(_MODELS[name](), procedural_palette()))
        os.replace(tmp, path)       # atomic: concurrent writers agree
    return path

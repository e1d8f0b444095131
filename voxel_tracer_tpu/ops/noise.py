"""Sampling noise: blue-noise textures + R2 frame decorrelation.

Analog of src/graphics/noise/{blue,sampler}.{h,cpp}: the reference samples
tiled blue-noise PNGs (LDR_RG01/LDR_RGB1, loaded with a sqrt pre-transform,
blue.cpp:5-17) and decorrelates frames with additive R2 irrational
sequences (sampler.h:22-36, frame wrapped at 120, renderer.cpp:161-162).

The real CC0 blue-noise PNG assets are used when found on the asset search
path (`VOX_ASSETS_DIR` env var, or `assets/noise` in the checkout);
otherwise a deterministic generated blue-noise-ish texture stands in, with
identical R2 frame-offset semantics either way.
"""

from __future__ import annotations

import functools
import os

import jax.numpy as jnp
import numpy as np

_ASSET_SEARCH = (
    os.environ.get("VOX_ASSETS_DIR", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "assets", "noise"),
)
_BLUE_FILES = {2: "LDR_RG01.png", 3: "LDR_RGB1.png"}


def _load_blue_png(channels: int):
    """Load the reference blue-noise PNG for the channel count, applying the
    loader transform of blue.cpp:12-16 (sRGB->linear then sqrt); None if the
    asset or a PNG decoder is unavailable."""
    name = _BLUE_FILES.get(channels)
    if name is None:
        return None
    for base in _ASSET_SEARCH:
        path = os.path.join(base, name) if base else None
        if path and os.path.isfile(path):
            try:
                from PIL import Image
                img = np.asarray(Image.open(path), np.float32) / 255.0
            except Exception:
                return None
            linear = img[..., :channels] ** 2.2   # stbi_loadf gamma
            return np.sqrt(linear).astype(np.float32)
    return None

# R2 irrationals (noise/blue.h:3-10)
R2 = 1.22074408460575947536
R2X, R2Y, R2Z = 1.0 / R2, 1.0 / R2 ** 2, 1.0 / R2 ** 3
R2_2D = 1.32471795724474602596
R2X_2D, R2Y_2D = 1.0 / R2_2D, 1.0 / R2_2D ** 2

_TEX_SIZE = 128


@functools.lru_cache(maxsize=4)
def _noise_texture(channels: int) -> np.ndarray:
    """(TEX, TEX, C) noise texture in [0, 1): the real blue-noise asset when
    available, else a deterministic generated stand-in.

    The stand-in's spectral blue-ness comes from jittered-grid
    stratification: good enough for soft-shadow/AO sampling without
    shipping binary assets.
    """
    real = _load_blue_png(channels)
    if real is not None:
        return real
    rng = np.random.RandomState(12345 + channels)
    tex = rng.rand(_TEX_SIZE, _TEX_SIZE, channels).astype(np.float32)
    # push toward blue noise: a few iterations of swap-based high-pass
    for c in range(channels):
        ch = tex[..., c]
        for _ in range(2):
            blur = (
                np.roll(ch, 1, 0) + np.roll(ch, -1, 0)
                + np.roll(ch, 1, 1) + np.roll(ch, -1, 1)
            ) * 0.25
            ch = np.clip(ch + 0.5 * (ch - blur), 0.0, 1.0)
        tex[..., c] = ch
    return tex


def sample_texture(xs, ys, channels: int):
    """Tiled texture fetch (BlueNoise::sample_* analog, blue.h:28-40)."""
    tex = jnp.asarray(_noise_texture(channels))
    th, tw = tex.shape[:2]
    xi = jnp.mod(xs, tw)
    yi = jnp.mod(ys, th)
    return tex[yi, xi]


def sample_3d(xs, ys, frame, offset=0.0):
    """NoiseSampler::sample_3d (sampler.h:22-29): tex + R2 * frame, mod 1."""
    base = sample_texture(xs, ys, 3)
    f = frame.astype(jnp.float32) + offset
    r2 = jnp.array([R2X, R2Y, R2Z], jnp.float32)
    return jnp.mod(base + r2 * f, 1.0)


def sample_2d(xs, ys, frame, offset=0.0):
    """NoiseSampler::sample_2d (sampler.h:31-36)."""
    base = sample_texture(xs, ys, 2)
    f = frame.astype(jnp.float32) + offset
    r2 = jnp.array([R2X_2D, R2Y_2D], jnp.float32)
    return jnp.mod(base + r2 * f, 1.0)


def sampler_3d(n_rays: int, frame, width: int = 0):
    """Per-ray 3D noise for a flat wavefront (ray index -> pixel coords)."""
    idx = jnp.arange(n_rays, dtype=jnp.int32)
    w = width if width else _TEX_SIZE
    return sample_3d(idx % w, idx // w, frame)


def sampler_2d(n_rays: int, frame, width: int = 0):
    idx = jnp.arange(n_rays, dtype=jnp.int32)
    w = width if width else _TEX_SIZE
    return sample_2d(idx % w, idx // w, frame)

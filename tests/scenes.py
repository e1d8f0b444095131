"""Scenes shared by several test files."""

import numpy as np

from voxel_tracer_tpu.models.scene import Scene
from voxel_tracer_tpu.models.skydome import SkyDome
from voxel_tracer_tpu.models.volume import VoxelVolume

W, H = 64, 48


def material_scene():
    """One 32^3 volume with every material row in view: diffuse floor,
    hollow glass box (row 0) with a diffuse pillar inside, mirror slab
    (row 1), plus a sphere light (the glass-box + drones scene shrunk to
    interpret-mode size)."""
    n = 32
    g = np.zeros((n, n, n), np.uint8)
    g[:, 0:3, :] = 30                      # diffuse floor (z, y, x); y up
    # hollow glass box, wall 2 voxels, occupying x [4,16), z [10,24)
    gb = (slice(10, 24), slice(3, 17), slice(4, 16))
    g[gb] = 3
    g[12:22, 5:15, 6:14] = 0               # hollow it out
    g[14:20, 3:11, 8:12] = 40              # diffuse pillar inside the glass
    g[:, 3:20, 26:28] = 12                 # mirror slab (row 1) at +x side
    pal = np.random.RandomState(7).rand(256, 3).astype(np.float32) * 0.8 + 0.1
    vol = VoxelVolume(g, palette=pal, pos=(0.0, 0.0, 0.0), vpu=20.0)
    scene = Scene(volumes=[vol], skydome=SkyDome.procedural(32, 16))
    scene.add_light((0.5, 1.2, -0.6), 0.08, (1.0, 0.9, 0.8), 6.0)
    return vol, scene


def sphere_grid(n=64, r=0.4, material=5):
    z, y, x = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    c = (n - 1) / 2.0
    d = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    return np.where(d < r * n, material, 0).astype(np.uint8)

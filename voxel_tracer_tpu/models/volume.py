"""Voxel volume: dense grid + brickmap occupancy + rigid transform.

Device-side analog of OVoxelVolume (src/graphics/primitives/vv.{h,cpp}): the
host-side `VoxelVolume` owns a mutable NumPy grid (dynamic voxel edits =
`set_voxel`, vv.cpp:377-432) and produces an immutable device pytree
(`VolumeData`) for the jitted render path.  The brickmap mirrors
`Brickmap`/`Brick512::voxcnt` (vv.h:23-38) as an 8^3-reduced occupancy-count
array; on the device the dense grid stays resident in memory and the occupancy array
drives coarse empty-space skipping.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from voxel_tracer_tpu.models.vox import VoxModel, load_vox
from voxel_tracer_tpu.ops.math3d import noise3d

BRICK = 8


class VolumeData(NamedTuple):
    """Immutable device-side volume (pytree leaf arrays)."""

    grid: jnp.ndarray       # (Z, Y, X) int32 material ids, 0 = air
    brick_occ: jnp.ndarray  # (BZ, BY, BX) int32 solid count per brick
    palette: jnp.ndarray    # (256, 3) f32 albedo
    rot: jnp.ndarray        # (3, 3) f32 rotation (local -> world)
    pos: jnp.ndarray        # (3,) f32 world position of pivot
    pivot: jnp.ndarray      # (3,) f32 local pivot
    vpu: jnp.ndarray        # () f32 voxels per unit


def compute_brick_occ(grid: np.ndarray) -> np.ndarray:
    """8^3 brick occupancy counts (Brick512::voxcnt analog)."""
    gz, gy, gx = grid.shape
    bz, by, bx = (math.ceil(s / BRICK) for s in (gz, gy, gx))
    pad = np.zeros((bz * BRICK, by * BRICK, bx * BRICK), np.uint8)
    pad[:gz, :gy, :gx] = grid != 0
    return (
        pad.reshape(bz, BRICK, by, BRICK, bx, BRICK)
        .sum(axis=(1, 3, 5))
        .astype(np.int32)
    )


class VoxelVolume:
    """Host-side voxel volume with dynamic edits (OVoxelVolume analog)."""

    def __init__(
        self,
        grid: np.ndarray,
        palette: Optional[np.ndarray] = None,
        pos=(0.0, 0.0, 0.0),
        rot: Optional[np.ndarray] = None,
        vpu: float = 20.0,  # reference default (vv.h:106)
    ):
        self.grid = np.ascontiguousarray(grid, np.uint8)
        gz, gy, gx = self.grid.shape
        self.grid_size = (gx, gy, gz)
        self.vpu = float(vpu)
        self.size = np.array([gx, gy, gz], np.float32) / self.vpu
        self.pos = np.asarray(pos, np.float32)
        self.rot = (np.eye(3, dtype=np.float32) if rot is None
                    else np.asarray(rot, np.float32))
        self.pivot = self.size * 0.5  # center pivot (vv.cpp:36)
        self.palette = (
            np.ones((256, 3), np.float32) if palette is None
            else np.asarray(palette, np.float32)
        )
        self.brick_occ = compute_brick_occ(self.grid)
        self._dirty = False

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_vox(path: str, pos=(0, 0, 0), model_id: int = 0,
                 vpu: float = 20.0) -> "VoxelVolume":
        """Load from .vox (OVoxelVolume(.vox) ctor analog, vv.cpp:12-54)."""
        model = load_vox(path, model_id)
        return VoxelVolume(model.grid, model.palette_f32, pos=pos, vpu=vpu)

    @staticmethod
    def from_model(model: VoxModel, pos=(0, 0, 0), vpu: float = 20.0) -> "VoxelVolume":
        return VoxelVolume(model.grid, model.palette_f32, pos=pos, vpu=vpu)

    @staticmethod
    def noise_filled(grid_size, pos=(0, 0, 0), vpu: float = 20.0,
                     threshold: float = 0.09, material: int = 16) -> "VoxelVolume":
        """Perlin-noise-filled test volume (vv.cpp:88-117 analog)."""
        nx, ny, nz = grid_size
        z, y, x = np.meshgrid(
            np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
        )
        n = noise3d(x / nx * 4.0, y / ny * 4.0, z / nz * 4.0)
        grid = np.where(n > threshold, material, 0).astype(np.uint8)
        return VoxelVolume(grid, pos=pos, vpu=vpu)

    # -- dynamic edits (set_voxel analog, vv.cpp:377-432) -------------------

    def set_voxel(self, x: int, y: int, z: int, value: int):
        gx, gy, gz = self.grid_size
        assert 0 <= x < gx and 0 <= y < gy and 0 <= z < gz, "Voxel out of range!"
        old = self.grid[z, y, x]
        if old == value:
            return
        self.grid[z, y, x] = value
        b = self.brick_occ[z // BRICK, y // BRICK, x // BRICK]
        if old == 0 and value != 0:
            self.brick_occ[z // BRICK, y // BRICK, x // BRICK] = b + 1
        elif old != 0 and value == 0:
            self.brick_occ[z // BRICK, y // BRICK, x // BRICK] = b - 1
        self._dirty = True

    def get_voxel(self, x: int, y: int, z: int) -> int:
        return int(self.grid[z, y, x])

    def to_grid(self, p_world: np.ndarray) -> np.ndarray:
        """World position -> integer voxel coords (vv.cpp:872-874 analog)."""
        p_local = self.rot.T @ (np.asarray(p_world, np.float32) - self.pos) + self.pivot
        return np.floor(p_local * self.vpu).astype(np.int32)

    # -- transforms ---------------------------------------------------------

    def set_position(self, pos):
        self.pos = np.asarray(pos, np.float32)

    def set_rotation(self, rot3: np.ndarray):
        self.rot = np.asarray(rot3, np.float32)

    def get_aabb(self):
        """Conservative world AABB via component-wise |R| (obb.cpp:37-46)."""
        half = self.size * 0.5
        center = self.rot @ (half - self.pivot) + self.pos
        extent = np.abs(self.rot) @ half
        return center - extent, center + extent

    # -- device upload ------------------------------------------------------

    def data(self) -> VolumeData:
        return VolumeData(
            grid=jnp.asarray(self.grid, jnp.int32),
            brick_occ=jnp.asarray(self.brick_occ),
            palette=jnp.asarray(self.palette),
            rot=jnp.asarray(self.rot),
            pos=jnp.asarray(self.pos),
            pivot=jnp.asarray(self.pivot),
            vpu=jnp.float32(self.vpu),
        )


def bake_aligned_scene(volumes: Sequence[VoxelVolume]) -> VoxelVolume:
    """Merge identity-rotation, grid-aligned volumes into one big volume.

    All volumes must share vpu and have positions on the voxel lattice; the
    merged volume uses volume 0's palette.  This turns the 512-instance
    profiling scene (src/dev/profile.h:23-36) into a single grid that one
    traversal covers.
    """
    assert volumes, "no volumes"
    vpu = volumes[0].vpu
    mins, maxs = [], []
    for v in volumes:
        assert np.allclose(v.rot, np.eye(3)), "bake requires axis-aligned"
        assert v.vpu == vpu, "bake requires uniform vpu"
        lo = v.pos - v.pivot
        mins.append(lo)
        maxs.append(lo + v.size)
    lo = np.floor(np.min(mins, axis=0) * vpu).astype(np.int64)
    hi = np.ceil(np.max(maxs, axis=0) * vpu).astype(np.int64)
    nx, ny, nz = (hi - lo).astype(int)
    grid = np.zeros((nz, ny, nx), np.uint8)
    for v in volumes:
        off = np.round((v.pos - v.pivot) * vpu).astype(np.int64) - lo
        gz, gy, gx = v.grid.shape
        region = grid[off[2]:off[2] + gz, off[1]:off[1] + gy,
                      off[0]:off[0] + gx]
        np.copyto(region, np.where(v.grid != 0, v.grid, region))
    merged = VoxelVolume(grid, palette=volumes[0].palette, vpu=vpu)
    merged.pos = (lo / vpu + merged.pivot).astype(np.float32)
    return merged

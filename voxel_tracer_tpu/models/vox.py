"""MagicaVoxel `.vox` parser (pure Python; the C++ fast path lives in
`native/`).

Re-implements the subset of the format the reference consumes through
`ogt_vox` (lib/ogt/ogt_vox.h + vv.cpp:12-54): RIFF-style chunks MAIN / PACK /
SIZE / XYZI / RGBA, multiple models, 256-entry palette.  Grid axis remap
matches vv.cpp:30,39-49: our (X, Y, Z) = (vox_size_y, vox_size_z, vox_size_x)
with the vox Y axis flipped, so models stand upright with Y up.

Format spec: https://github.com/ephtracy/voxel-model/blob/master/MagicaVoxel-file-format-vox.txt
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import List

import numpy as np


def _default_palette() -> np.ndarray:
    """The canonical MagicaVoxel default palette (256 x RGBA uint8).

    Constructed from the documented layout: a 6x6x6 color cube followed by
    R/G/B/gray ramps; index 0 is transparent black.
    """
    pal = np.zeros((256, 4), np.uint8)
    levels = [255, 204, 153, 102, 51, 0]
    i = 1
    for r in levels:
        for g in levels:
            for b in levels:
                if i >= 256:
                    break
                if (r, g, b) == (0, 0, 0):
                    continue
                pal[i] = (r, g, b, 255)
                i += 1
    ramp = [238, 221, 187, 170, 136, 119, 85, 68, 34, 17]
    for v in ramp:
        pal[i] = (v, 0, 0, 255); i += 1
    for v in ramp:
        pal[i] = (0, v, 0, 255); i += 1
    for v in ramp:
        pal[i] = (0, 0, v, 255); i += 1
    for v in ramp:
        pal[i] = (v, v, v, 255); i += 1
    return pal


@dataclass
class VoxModel:
    """One model from a .vox file, already remapped to our (Z, Y, X) grid."""

    grid: np.ndarray                 # (Z, Y, X) uint8 material ids
    palette: np.ndarray              # (256, 4) uint8 RGBA
    size: tuple = field(default=None)  # our (nx, ny, nz)

    def __post_init__(self):
        gz, gy, gx = self.grid.shape
        self.size = (gx, gy, gz)

    @property
    def palette_f32(self) -> np.ndarray:
        """(256, 3) float albedo in [0, 1] (RGB8_to_RGBF32 analog)."""
        return self.palette[:, :3].astype(np.float32) / 255.0


def _native_module():
    """The C fast parser (native/voxparse.c), built at first use."""
    import importlib
    import sys
    import sysconfig

    from voxel_tracer_tpu.utils.native import NATIVE_DIR, ensure_built

    if "_voxnative" in sys.modules:
        return sys.modules["_voxnative"]
    lib = os.path.join(NATIVE_DIR, "_voxnative"
                       + sysconfig.get_config_var("EXT_SUFFIX"))
    if not ensure_built(lib):
        return None
    if NATIVE_DIR not in sys.path:
        sys.path.append(NATIVE_DIR)
    try:
        return importlib.import_module("_voxnative")
    except ImportError:
        return None


def parse_vox(data: bytes, use_native: bool = True) -> List[VoxModel]:
    """Parse .vox bytes into a list of models (shared palette).

    Uses the C extension when available (zero per-voxel Python work);
    falls back to the pure-Python chunk walker below.
    """
    native = _native_module() if use_native else None
    if native is not None:
        raw_models, pal_bytes = native.parse_vox(data)
        palette = (
            np.frombuffer(pal_bytes, np.uint8).reshape(256, 4).copy()
            if pal_bytes is not None else _default_palette())
        out = []
        for (sx, sy, sz, grid_bytes) in raw_models:
            grid = np.frombuffer(grid_bytes, np.uint8).reshape(sx, sz, sy)
            out.append(VoxModel(grid=grid.copy(), palette=palette))
        return out

    if data[:4] != b"VOX ":
        raise ValueError("not a .vox file (missing 'VOX ' magic)")
    # version = struct.unpack_from("<i", data, 4)[0]
    pos = 8

    sizes = []
    xyzis = []
    palette = _default_palette()

    def read_chunk(pos):
        cid = data[pos : pos + 4]
        n, m = struct.unpack_from("<ii", data, pos + 4)
        content = data[pos + 12 : pos + 12 + n]
        return cid, content, pos + 12 + n, m

    end = len(data)
    while pos + 12 <= end:
        cid, content, nxt, _children = read_chunk(pos)
        if cid == b"SIZE":
            sizes.append(struct.unpack_from("<iii", content, 0))
        elif cid == b"XYZI":
            (cnt,) = struct.unpack_from("<i", content, 0)
            arr = np.frombuffer(content, np.uint8, count=cnt * 4, offset=4)
            xyzis.append(arr.reshape(cnt, 4))
        elif cid == b"RGBA":
            raw = np.frombuffer(content, np.uint8, count=256 * 4).reshape(256, 4)
            # RGBA chunk color i maps to palette index i+1 (spec)
            palette = np.zeros((256, 4), np.uint8)
            palette[1:] = raw[:255]
        elif cid == b"MAIN":
            nxt = pos + 12  # descend into children
        pos = nxt

    models = []
    for (sx, sy, sz), vox in zip(sizes, xyzis):
        # Voxels are (x, y, z, color_index) in vox coords
        v = np.zeros((sz, sy, sx), np.uint8)
        if len(vox):
            v[vox[:, 2].astype(np.int64), vox[:, 1].astype(np.int64),
              vox[:, 0].astype(np.int64)] = vox[:, 3]
        # Axis remap (vv.cpp:39-49): grid[vx, vz, sy-1-vy] = vox[vz, vy, vx]
        grid = v.transpose(2, 0, 1)[:, :, ::-1].copy()
        models.append(VoxModel(grid=grid, palette=palette))
    return models


def load_vox(path: str, model_id: int = 0) -> VoxModel:
    """Load one model from a .vox file (OVoxelVolume ctor analog, vv.cpp:12-54)."""
    with open(path, "rb") as f:
        models = parse_vox(f.read())
    return models[model_id]


def encode_vox(grid: np.ndarray, palette: np.ndarray | None = None) -> bytes:
    """Encode one (Z, Y, X) material grid as .vox bytes (`parse_vox` inverse).

    palette: optional (256, 4) uint8 RGBA, index 0 unused (written as the
    RGBA chunk, whose color i is palette index i + 1).
    """
    grid = np.asarray(grid, np.uint8)
    gz, gy, gx = grid.shape
    # inverse of the axis remap: grid[vx, vz, sy-1-vy] = vox(vx, vy, vz)
    sx, sy, sz = gz, gx, gy
    a, b, c = np.nonzero(grid)
    xyzi = np.stack([a, sy - 1 - c, b, grid[a, b, c]], axis=1).astype(np.uint8)

    def chunk(cid, content, children=b""):
        return (cid + struct.pack("<ii", len(content), len(children))
                + content + children)

    body = chunk(b"SIZE", struct.pack("<iii", sx, sy, sz))
    body += chunk(b"XYZI", struct.pack("<i", len(xyzi)) + xyzi.tobytes())
    if palette is not None:
        raw = np.zeros((256, 4), np.uint8)
        raw[:255] = np.asarray(palette, np.uint8)[1:]
        body += chunk(b"RGBA", raw.tobytes())
    return b"VOX " + struct.pack("<i", 150) + chunk(b"MAIN", b"", body)


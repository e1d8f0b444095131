"""MagicaVoxel loader tests on the seeded `.vox` assets
(models/assets.py writes them as real files at first use)."""

import numpy as np
import pytest

from voxel_tracer_tpu.models.assets import ASSET_NAMES, asset_path
from voxel_tracer_tpu.models.vox import (
    _default_palette, encode_vox, load_vox, parse_vox)


class TestRealAssets:
    def test_crate16(self):
        m = load_vox(asset_path("crate-16.vox"))
        assert m.grid.ndim == 3
        assert (m.grid != 0).sum() > 0
        assert m.palette.shape == (256, 4)
        # crate-16 is a 32^3-ish crate model
        assert max(m.grid.shape) <= 64

    def test_glass_box(self):
        m = load_vox(asset_path("testing/glass-box.vox"))
        ids = np.unique(m.grid)
        assert 0 in ids and len(ids) > 1

    def test_enemy_drone(self):
        m = load_vox(asset_path("enemy-drone.vox"))
        assert (m.grid != 0).sum() > 10

    def test_palette_rgba(self):
        m = load_vox(asset_path("crate-16.vox"))
        # palette index 0 is transparent/empty
        assert tuple(m.palette[0]) == (0, 0, 0, 0)
        pf = m.palette_f32
        assert pf.shape == (256, 3)
        assert pf.max() <= 1.0

    def test_axis_remap_upright(self):
        """Reference remap puts vox Z (up) on our Y axis (vv.cpp:30)."""
        m = load_vox(asset_path("enemy-drone.vox"))
        gz, gy, gx = m.grid.shape
        assert (gx, gy, gz) != (0, 0, 0)


def test_synthetic_roundtrip():
    """Build a minimal .vox in memory and parse it."""
    import struct

    sx, sy, sz = 3, 4, 5
    voxels = [(0, 0, 0, 1), (2, 3, 4, 7), (1, 1, 1, 42)]
    size = struct.pack("<iii", sx, sy, sz)
    xyzi = struct.pack("<i", len(voxels)) + b"".join(
        struct.pack("<BBBB", *v) for v in voxels)

    def chunk(cid, content, children=b""):
        return cid + struct.pack("<ii", len(content), len(children)) + content + children

    body = chunk(b"SIZE", size) + chunk(b"XYZI", xyzi)
    data = b"VOX " + struct.pack("<i", 150) + chunk(b"MAIN", b"", body)

    models = parse_vox(data)
    assert len(models) == 1
    g = models[0].grid
    # our grid (Z, Y, X) = (sx, sz, sy)
    assert g.shape == (sx, sz, sy)
    # vox (vx,vy,vz) -> grid[vx, vz, sy-1-vy]
    assert g[0, 0, sy - 1 - 0] == 1
    assert g[2, 4, sy - 1 - 3] == 7
    assert g[1, 1, sy - 1 - 1] == 42


def test_default_palette_shape():
    pal = _default_palette()
    assert pal.shape == (256, 4)
    assert tuple(pal[0]) == (0, 0, 0, 0)
    assert tuple(pal[1]) == (255, 255, 255, 255)


@pytest.mark.parametrize("name", ASSET_NAMES)
def test_encode_parse_roundtrip(name):
    """`encode_vox` inverts `parse_vox`: grid, axis remap and palette."""
    from voxel_tracer_tpu.models import assets

    grid = assets._MODELS[name]()
    pal = assets.procedural_palette()
    m = parse_vox(encode_vox(grid, pal), use_native=False)[0]
    np.testing.assert_array_equal(m.grid, grid)
    np.testing.assert_array_equal(m.palette, pal)


def test_glass_box_materials():
    """The glass box carries the glass (4) and mirror (12) rows."""
    ids = set(np.unique(load_vox(asset_path("testing/glass-box.vox")).grid))
    assert {4, 12} <= ids


"""Native C/C++ components (built from `native/` at first use): fast .vox
parser and C++ oracle parity."""

import numpy as np
import pytest

from voxel_tracer_tpu.models.assets import ASSET_NAMES, asset_path
from voxel_tracer_tpu.models.vox import parse_vox, _native_module
from voxel_tracer_tpu.models.volume import VoxelVolume
from voxel_tracer_tpu.ops import oracle, oracle_native


@pytest.fixture
def native_parser():
    if _native_module() is None:
        pytest.skip("native parser could not be built (no C compiler)")


@pytest.fixture
def native_oracle():
    if not oracle_native.available():
        pytest.skip("liboracle.so could not be built (no C++ compiler)")


class TestNativeVoxParser:
    @pytest.mark.parametrize("name", ASSET_NAMES)
    def test_matches_python_parser(self, name, native_parser):
        raw = open(asset_path(name), "rb").read()
        a = parse_vox(raw, use_native=True)
        b = parse_vox(raw, use_native=False)
        assert len(a) == len(b)
        for ma, mb in zip(a, b):
            np.testing.assert_array_equal(ma.grid, mb.grid)
            np.testing.assert_array_equal(ma.palette, mb.palette)


class TestNativeOracle:
    def test_matches_python_oracle(self, native_oracle):
        vol = VoxelVolume.noise_filled((24, 24, 24))
        rng = np.random.RandomState(11)
        n = 200
        o_l = (rng.rand(n, 3) * 2.4 - 1.2
               + np.asarray(vol.pivot)).astype(np.float32)
        d = rng.randn(n, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        res = oracle_native.trace(vol.grid, vol.brick_occ, vol.vpu, o_l, d)
        ov = oracle.OracleVolume(grid=vol.grid, vpu=vol.vpu)
        bad = 0
        for i in range(n):
            h = oracle.intersect_volume(
                ov, o_l[i] - np.asarray(vol.pivot), d[i])
            if h.no_hit != (res["t"][i] >= 1e29):
                bad += 1
                continue
            if h.no_hit:
                continue
            if (not np.isclose(res["t"][i], h.depth, atol=2e-3)
                    or res["mat"][i] != h.material):
                bad += 1
        assert bad == 0

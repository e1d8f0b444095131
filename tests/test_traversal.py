"""Traversal parity: `dda.intersect_volume_local` vs the scalar oracle.

Every case runs once per implementation: the XLA wavefront (``xla``) and
the Triton kernel of `ops/pallas/dda_gpu.py` in Pallas interpret mode
(``interpret``), over several scenes and the four ray variants (plain,
interior ``medium`` march, ``ignore`` scan rays, stochastic ``shadow``).
On the GPU the kernel must match the wavefront on all but 1e-4 of rays,
with t to 1e-5 relative on the rest (`chip_smoke.py` phase 2); here, with
no FMA contraction on either side, both must match the oracle on every
sampled ray.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from tests.scenes import sphere_grid
from voxel_tracer_tpu.models.volume import VoxelVolume, bake_aligned_scene
from voxel_tracer_tpu.ops import dda, oracle
from voxel_tracer_tpu.ops.composite import _to_local
from voxel_tracer_tpu.ops.math3d import quat_from_axis_angle, quat_to_mat3

IMPLS = ["xla", "interpret"]
VARIANTS = ["plain", "medium", "ignore", "shadow"]


def _scene(name):
    """(VoxelVolume, camera position) for a named test scene."""
    if name == "sphere":
        return VoxelVolume(sphere_grid(32), pos=(0.5, -0.2, 0.1)), (2.5, 1.5, -2.5)
    if name == "rotated_sphere":
        rot = np.asarray(quat_to_mat3(quat_from_axis_angle((0, 1, 0), 0.7)))
        return VoxelVolume(sphere_grid(32), rot=rot), (0.0, 0.5, -4.0)
    if name == "noise_odd_shape":
        # not a multiple of the 8^3 brick on any axis
        return VoxelVolume.noise_filled((36, 44, 40)), (-2.0, 2.0, -4.0)
    if name == "crates":
        from voxel_tracer_tpu.utils.profiling import profiling_volumes
        return bake_aligned_scene(profiling_volumes(2)), (-1.2, 3.6, -1.6)
    if name == "glass_box":
        from voxel_tracer_tpu.models.assets import asset_path
        return (VoxelVolume.from_vox(asset_path("testing/glass-box.vox")),
                (1.4, 1.1, -1.8))
    raise KeyError(name)


SCENES = ["sphere", "rotated_sphere", "noise_odd_shape", "crates",
          "glass_box"]


def _rays(vol, cam_pos, variant, seed=0, n_cam=96, n_inner=64):
    """Camera rays toward the volume center plus random rays that start
    inside it; per-ray variant inputs."""
    rng = np.random.RandomState(seed)
    center = vol.get_aabb()[0] * 0.5 + vol.get_aabb()[1] * 0.5
    cam = np.asarray(cam_pos, np.float32)
    jitter = rng.uniform(-0.6, 0.6, (n_cam, 3)) * vol.size.max()
    d_cam = center + jitter - cam
    lo, hi = vol.get_aabb()
    o_in = rng.uniform(lo, hi, (n_inner, 3))
    d_in = rng.randn(n_inner, 3)
    o = np.concatenate([np.tile(cam, (n_cam, 1)), o_in]).astype(np.float32)
    d = np.concatenate([d_cam, d_in]).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    n = len(o)
    ids = np.unique(vol.grid[vol.grid > 0])
    pick = rng.choice(ids, n).astype(np.int32)
    kw = {}
    if variant == "medium":
        kw["medium"] = np.where(rng.rand(n) < 0.7, pick, 0).astype(np.int32)
    elif variant == "ignore":
        kw["ignore"] = np.where(rng.rand(n) < 0.7, pick, 0).astype(np.int32)
    elif variant == "shadow":
        kw["shadow_seed"] = rng.randint(0, 2 ** 31, n).astype(np.uint32)
    return o, d, kw


def _trace(vol, o, d, impl, **kw):
    data = vol.data()
    o_l, d_l = _to_local(data.rot, data.pos, data.pivot, jnp.asarray(o),
                         jnp.asarray(d))
    shadow = "shadow_seed" in kw
    res = dda.intersect_volume_local(
        data.grid, data.brick_occ, o_l, d_l, data.vpu, impl=impl,
        shadow=shadow, **{k: jnp.asarray(v) for k, v in kw.items()})
    return {k: np.asarray(v) for k, v in res.items()}


def _oracle(vol, o, d, kw):
    ov = oracle.OracleVolume(grid=vol.grid, vpu=vol.vpu, pos=vol.pos,
                             rot=vol.rot)
    out = []
    for i in range(len(o)):
        flags = {}
        if "medium" in kw:
            flags["medium"] = int(kw["medium"][i])
        if "ignore" in kw:
            flags["ignore"] = int(kw["ignore"][i])
        if "shadow_seed" in kw:
            flags.update(shadow=True, seed=int(kw["shadow_seed"][i]))
        out.append(oracle.intersect_volume(ov, o[i], d[i], **flags))
    return out


def _assert_matches_oracle(vol, o, d, kw, res):
    bad = []
    for i, h in enumerate(_oracle(vol, o, d, kw)):
        hit = res["t"][i] < 1e29
        if h.no_hit != (not hit):
            bad.append((i, "hit", h.depth, res["t"][i]))
            continue
        if h.no_hit:
            continue
        # the oracle leaves the normal zero on a slab miss inside a medium
        n_l = np.abs(vol.rot.T @ h.normal)
        axis = int(np.argmax(n_l)) if n_l.any() else res["axis"][i]
        if (res["mat"][i] != h.material or res["axis"][i] != axis
                or not np.isclose(res["t"][i], h.depth, rtol=1e-5,
                                  atol=1e-5)):
            bad.append((i, res["mat"][i], h.material, res["axis"][i], axis,
                        res["t"][i], h.depth))
    assert not bad, f"{len(bad)}/{len(o)} rays differ: {bad[:5]}"


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("scene", SCENES)
def test_matches_oracle(scene, variant, impl):
    vol, cam = _scene(scene)
    o, d, kw = _rays(vol, cam, variant)
    res = _trace(vol, o, d, impl, **kw)
    assert (res["steps"] <= dda.MAX_STEPS).all()
    if variant == "medium":
        inside = kw["medium"] > 0
        assert (res["t"][inside] < 1e29).all(), "interior rays never miss"
    _assert_matches_oracle(vol, o, d, kw, res)


@pytest.mark.parametrize("impl", IMPLS)
def test_multi_object_oid(impl):
    """Stacked (O, Z, Y, X) grids with per-ray object indices: each ray
    traces only its own object, as the oracle does for that volume."""
    vols = [VoxelVolume(sphere_grid(24, 0.3, 20 + k)) for k in range(2)]
    vols.append(VoxelVolume.noise_filled((24, 24, 24), material=40))
    grid = jnp.stack([v.data().grid for v in vols])
    occ = jnp.stack([v.data().brick_occ for v in vols])
    o, d, _ = _rays(vols[0], (1.5, 1.0, -2.0), "plain", seed=4)
    oid = np.random.RandomState(4).randint(0, 3, len(o)).astype(np.int32)
    pivot = vols[0].pivot
    res = dda.intersect_volume_local(
        grid, occ, jnp.asarray(o + pivot), jnp.asarray(d), 20.0,
        oid=jnp.asarray(oid), impl=impl)
    res = {k: np.asarray(v) for k, v in res.items()}
    for k, vol in enumerate(vols):
        sel = oid == k
        _assert_matches_oracle(vol, o[sel], d[sel], {},
                               {key: v[sel] for key, v in res.items()})


@pytest.mark.parametrize("variant", VARIANTS)
def test_kernel_equals_wavefront(variant):
    """Interpret-mode kernel vs XLA wavefront on the same rays: every
    output identical (no FMA contraction on the CPU)."""
    vol, cam = _scene("noise_odd_shape")
    o, d, kw = _rays(vol, cam, variant, seed=9, n_cam=200, n_inner=200)
    a = _trace(vol, o, d, "xla", **kw)
    b = _trace(vol, o, d, "interpret", **kw)
    for k in ("t", "mat", "axis", "steps", "valid"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("impl", IMPLS)
def test_budget_exhaustion_is_per_ray(impl):
    """A ray's result does not depend on the other rays of its batch: a
    medium ray that runs out of budget exits at the slab tmax whether or
    not a longer ray keeps the loop going."""
    g = np.full((32, 32, 32), 4, np.uint8)       # solid glass block
    vol = VoxelVolume(g, vpu=20.0)
    data = vol.data()
    o = np.array([[0.8, 0.8, 0.01], [0.01, 0.8, 0.8]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]], np.float32)
    med = np.array([4, 4], np.int32)

    def run(rows, steps):
        r = dda.intersect_volume_local(
            data.grid, data.brick_occ, jnp.asarray(o[rows]),
            jnp.asarray(d[rows]), data.vpu, max_steps=steps,
            medium=jnp.asarray(med[rows]), impl=impl)
        return {k: np.asarray(v) for k, v in r.items()}

    alone = run([0], 8)
    batch = run([0, 1], 8)
    assert alone["t"][0] < 1e29, "exhausted interior ray must exit"
    np.testing.assert_allclose(alone["t"][0], alone["slab_tmax"][0])
    for k in ("t", "mat", "axis", "steps"):
        assert alone[k][0] == batch[k][0], k

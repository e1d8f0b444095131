"""Glass: medium/ignore/shadow traversal parity + end-to-end refraction.

Parity targets the reference semantics of vv.cpp:166-232,297-335 (interior
exit march, scan-ray pass-through, stochastic shadow absorption) and
materials.cpp:119-189 (eval_glass: Beer absorption, Fresnel split, bounded
internal reflections, weight applied to albedo AND irradiance).
"""

import numpy as np
import jax.numpy as jnp

from voxel_tracer_tpu.models.scene import Scene
from voxel_tracer_tpu.models.skydome import SkyDome
from voxel_tracer_tpu.models.volume import VoxelVolume
from voxel_tracer_tpu.ops import composite, dda, oracle
from voxel_tracer_tpu.ops.math3d import BIG_F32
from voxel_tracer_tpu.renderer import Renderer, RenderConfig

GLASS_MAT = 3   # material row 0 (ids 1..8) = glass
CORE_MAT = 20   # metal row — a solid interior obstacle


def _glass_blob(n=24):
    z, y, x = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    c = (n - 1) / 2.0
    d = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    g = np.where(d < 0.42 * n, GLASS_MAT, 0).astype(np.uint8)
    g[d < 0.15 * n] = CORE_MAT   # interior solid the exit march can hit
    return g


def _local_rays(vol, origins, dirs):
    rt = vol.rot.T
    o_l = (origins - vol.pos) @ rt.T + vol.pivot
    d_l = dirs @ rt.T
    return jnp.asarray(o_l, jnp.float32), jnp.asarray(d_l, jnp.float32)


def _compare_flags(vol, origins, dirs, dda_kw, oracle_kw, budget_div=100):
    """dda vs oracle under identical medium/ignore/shadow flags."""
    data = vol.data()
    o_l, d_l = _local_rays(vol, origins, dirs)
    res = dda.intersect_volume_local(
        data.grid, data.brick_occ, o_l, d_l, data.vpu, **dda_kw)
    t = np.asarray(res["t"])
    mat = np.asarray(res["mat"])
    ovol = oracle.OracleVolume(grid=vol.grid, vpu=vol.vpu, pos=vol.pos,
                               rot=vol.rot, palette=vol.palette)
    n = origins.shape[0]
    n_mismatch = 0
    for i in range(n):
        kw = {k: (v[i] if hasattr(v, "__len__") else v)
              for k, v in oracle_kw.items()}
        h = oracle.intersect_volume(ovol, origins[i], dirs[i], **kw)
        if h.no_hit != (t[i] >= BIG_F32 * 0.99):
            n_mismatch += 1
            continue
        if h.no_hit:
            continue
        if not np.isclose(t[i], h.depth, atol=2e-3, rtol=1e-4):
            n_mismatch += 1
            continue
        assert mat[i] == h.material, (
            f"ray {i}: mat {mat[i]} vs oracle {h.material}")
    # PINNED budget: observed 0 mismatches across all glass scenes
    # (2026-08 audit; budget_div retained in signatures for API stability)
    assert n_mismatch <= 2, (
        f"{n_mismatch}/{n} hit/depth mismatches")


class TestInteriorMarch:
    def test_medium_exit_parity(self, rng):
        """Interior rays (medium set) exit exactly where the oracle does:
        first non-medium voxel, empty brick, or OBB exit plane."""
        vol = VoxelVolume(_glass_blob(), vpu=20.0)
        n = 256
        # origins inside the glass shell, random directions
        r = 0.30 * 24 / 20.0
        u = rng.randn(n, 3); u /= np.linalg.norm(u, axis=1, keepdims=True)
        origins = (u * r * rng.uniform(0.8, 1.0, (n, 1))).astype(np.float32)
        d = rng.randn(n, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        med = np.full((n,), GLASS_MAT, np.int32)
        _compare_flags(vol, origins, d,
                       dict(medium=jnp.asarray(med)),
                       dict(medium=GLASS_MAT))

    def test_medium_never_misses(self, rng):
        """Interior rays always report an exit (t < BIG_F32)."""
        vol = VoxelVolume(_glass_blob(), vpu=20.0)
        data = vol.data()
        n = 128
        origins = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
        d = rng.randn(n, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o_l, d_l = _local_rays(vol, origins, d)
        res = dda.intersect_volume_local(
            data.grid, data.brick_occ, o_l, d_l, data.vpu,
            medium=jnp.full((n,), GLASS_MAT, jnp.int32))
        assert bool((np.asarray(res["t"]) < BIG_F32).all())

    def test_exit_at_obb_boundary(self):
        """A full glass cube: interior ray down +x exits at the far face
        (exit_t = slab tmax, obb.cpp:82-106 analog)."""
        g = np.full((16, 16, 16), GLASS_MAT, np.uint8)
        vol = VoxelVolume(g, vpu=20.0)   # size 0.8, centered at origin
        data = vol.data()
        o_l = jnp.asarray([[0.01, 0.4, 0.4]], jnp.float32)  # local coords
        d_l = jnp.asarray([[1.0, 0.0, 0.0]], jnp.float32)
        res = dda.intersect_volume_local(
            data.grid, data.brick_occ, o_l, d_l, data.vpu,
            medium=jnp.asarray([GLASS_MAT], jnp.int32))
        np.testing.assert_allclose(np.asarray(res["t"])[0], 0.79, atol=1e-4)
        assert int(np.asarray(res["mat"])[0]) == 0


class TestScanRays:
    def test_ignore_medium_parity(self, rng):
        """Scan rays skip their own medium until air is seen."""
        vol = VoxelVolume(_glass_blob(), vpu=20.0)
        n = 200
        origins = (rng.randn(n, 3) * 0.1).astype(np.float32)
        d = rng.randn(n, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ign = np.full((n,), GLASS_MAT, np.int32)
        _compare_flags(vol, origins, d,
                       dict(ignore=jnp.asarray(ign)),
                       dict(ignore=GLASS_MAT))

    def test_ignore_zero_is_plain(self, rng):
        """ignore = 0 (the no-op sentinel) must match the plain march."""
        vol = VoxelVolume(_glass_blob(), vpu=20.0)
        data = vol.data()
        n = 64
        origins = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        d = rng.randn(n, 3).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        o_l, d_l = _local_rays(vol, origins, d)
        a = dda.intersect_volume_local(
            data.grid, data.brick_occ, o_l, d_l, data.vpu)
        b = dda.intersect_volume_local(
            data.grid, data.brick_occ, o_l, d_l, data.vpu,
            ignore=jnp.zeros((n,), jnp.int32))
        np.testing.assert_allclose(np.asarray(a["t"]), np.asarray(b["t"]))
        np.testing.assert_array_equal(np.asarray(a["mat"]),
                                      np.asarray(b["mat"]))


class TestShadowRays:
    def test_shadow_stochastic_parity(self, rng):
        """Shadow semantics: ids > 16 block, glass blocks with p = 0.15 via
        the shared deterministic hash — exact dda/oracle agreement."""
        vol = VoxelVolume(_glass_blob(), vpu=20.0)
        n = 256
        origins = np.tile(np.array([[0.0, 0.0, -2.0]], np.float32), (n, 1))
        targets = rng.uniform(-0.6, 0.6, (n, 3)).astype(np.float32)
        d = targets - origins
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        seeds = rng.randint(0, 2**31, n).astype(np.uint32)
        _compare_flags(vol, origins, d,
                       dict(shadow=True, shadow_seed=jnp.asarray(seeds)),
                       dict(shadow=True, seed=seeds))

    def test_glass_shadows_mostly_pass(self, rng):
        """A thin glass pane blocks ~15% of shadow rays, not all."""
        g = np.zeros((16, 16, 16), np.uint8)
        g[:, 8, :] = GLASS_MAT    # one-voxel-thick pane
        vol = VoxelVolume(g, vpu=20.0)
        data = vol.data()
        n = 512
        x = rng.uniform(-0.35, 0.35, n).astype(np.float32)
        z = rng.uniform(-0.35, 0.35, n).astype(np.float32)
        origins = np.stack([x, np.full(n, -2.0, np.float32), z], axis=1)
        d = np.tile(np.array([[0.0, 1.0, 0.0]], np.float32), (n, 1))
        o_l, d_l = _local_rays(vol, origins, d)
        res = dda.intersect_volume_local(
            data.grid, data.brick_occ, o_l, d_l, data.vpu,
            shadow=True,
            shadow_seed=jnp.arange(n, dtype=jnp.uint32)
            * jnp.uint32(2654435761))
        blocked = (np.asarray(res["t"]) < BIG_F32).mean()
        assert 0.05 < blocked < 0.30, blocked   # expect ~0.15


class TestGlassShading:
    def test_glass_cube_beer_tint(self):
        """Golden: a green glass cube on a white sky.  Perpendicular center
        ray: refract straight through, Beer absorb over the 0.8-unit
        thickness, one Fresnel-weighted exit; reference applies the weight
        to albedo and irradiance so color = sky * (absorb * (1-R))^2 with
        R = 0.01 + 0.99 * schlick(1.5, 1.0) = 0.0496."""
        g = np.full((16, 16, 16), GLASS_MAT, np.uint8)
        palette = np.ones((256, 3), np.float32)
        palette[GLASS_MAT] = (0.7, 1.0, 0.7)
        vol = VoxelVolume(g, palette, pos=(0.0, 0.0, 0.0), vpu=20.0)
        scene = Scene(volumes=[vol], skydome=SkyDome.constant((1, 1, 1)))
        cfg = RenderConfig(width=32, height=32, shading="full",
                           tonemapper="none", max_bounces=3,
                           glass_reflections=2)
        r = Renderer(cfg)
        cam = r.camera((0.0, 0.0, -3.0), (0.0, 0.0, 0.0))
        out = r.render(scene.data(), cam, frame=0)
        img = np.asarray(out["image"])
        center = img[16, 16]
        # analytic: w = exp(-(1-albedo)*2*0.8) * (1 - 0.0496); color = w^2
        absorb = np.exp(-(1.0 - palette[GLASS_MAT]) * 2.0 * 0.8)
        expect = (absorb * (1.0 - 0.0496)) ** 2
        np.testing.assert_allclose(center, expect, atol=0.05)
        assert center[1] > center[0] + 0.2   # strong green Beer tint

    def test_glass_sees_object_behind(self):
        """Refraction continuity: a diffuse wall behind a glass slab is
        visible through it (the scan ray passes the medium)."""
        g = np.full((8, 32, 32), GLASS_MAT, np.uint8)     # thin z-slab
        palette = np.ones((256, 3), np.float32)
        palette[GLASS_MAT] = (0.9, 0.9, 1.0)
        slab = VoxelVolume(g, palette, pos=(0, 0, 0), vpu=20.0)
        wall_g = np.full((4, 32, 32), CORE_MAT, np.uint8)
        wall_p = np.ones((256, 3), np.float32)
        wall_p[CORE_MAT] = (1.0, 0.2, 0.2)                # red wall
        wall = VoxelVolume(wall_g, wall_p, pos=(0, 0, 1.0), vpu=20.0)
        scene = Scene(volumes=[slab, wall],
                      skydome=SkyDome.constant((0.1, 0.1, 0.1)))
        cfg = RenderConfig(width=24, height=24, shading="full",
                           tonemapper="none", max_bounces=3,
                           glass_reflections=2)
        r = Renderer(cfg)
        cam = r.camera((0.0, 0.0, -2.5), (0.0, 0.0, 0.0))
        out = r.render(scene.data(), cam, frame=0)
        # the wall sits inside the slab's (stochastic) shadow, so check the
        # albedo AOV: refraction continuity puts the red wall's albedo
        # (weighted by the glass Fresnel/Beer factor) at the center pixel
        center = np.asarray(out["albedo"])[12, 12]
        assert center[0] > 0.3, center           # wall visible through glass
        assert center[0] > 2.0 * center[1]       # and it is red
        assert np.isfinite(np.asarray(out["image"])).all()

    def test_glass_box_vox_renders(self):
        """The glass test box asset renders non-black under full shading."""
        from voxel_tracer_tpu.models.assets import asset_path

        vol = VoxelVolume.from_vox(asset_path("testing/glass-box.vox"))
        scene = Scene(volumes=[vol], skydome=SkyDome.procedural(64, 32))
        cfg = RenderConfig(width=32, height=32, shading="full",
                           max_bounces=3, glass_reflections=2)
        r = Renderer(cfg)
        cam = r.camera((1.2, 1.0, -1.6), (0.0, 0.0, 0.0))
        out = r.render(scene.data(), cam, frame=0)
        img = np.asarray(out["image"])
        assert img.mean() > 0.02, img.mean()
        assert np.isfinite(img).all()

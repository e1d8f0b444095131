"""Live-ray compaction (ops/compact.py + RenderConfig.compact).

Compaction is a pure re-ordering: each stage computes identical per-row
math on a gathered subset, so on the per-ray-independent XLA wavefront
backend the compacted image must match the uncompacted one exactly."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.ops.compact import bucket_caps, live_indices, \
    masked_apply


def test_live_indices_matches_nonzero(rng):
    for n, cap in [(64, 16), (64, 64), (128, 32), (1024, 256)]:
        mask = rng.rand(n) < 0.15
        if mask.sum() > cap:
            mask[np.cumsum(mask) > cap] = False
        idx = np.asarray(live_indices(jnp.asarray(mask), cap))
        want = np.flatnonzero(mask)
        assert (idx[:len(want)] == want).all()
        assert (idx[len(want):] == n).all()


def test_bucket_caps_ladder():
    caps = bucket_caps(983040, (1 / 16, 1 / 4, 1 / 2))
    assert caps[-1] == 983040
    assert all(c % 1024 == 0 for c in caps)
    assert list(caps) == sorted(caps)
    # tiny n collapses to a single full bucket
    assert bucket_caps(512, (1 / 16,))[-1] == 512


@pytest.mark.parametrize("frac", [0.02, 0.2, 0.8])
def test_masked_apply_scatters_only_masked_rows(rng, frac):
    n = 4096
    mask = jnp.asarray(rng.rand(n) < frac)
    x = jnp.asarray(rng.rand(n, 3).astype(np.float32))
    base = jnp.full((n, 3), -5.0)

    def fn(live, idx, xg):
        return xg * 2.0 + 1.0

    out = masked_apply(mask, fn, (x,), base,
                       bucket_caps(n, (1 / 16, 1 / 4)))
    out = np.asarray(out)
    m = np.asarray(mask)
    np.testing.assert_allclose(out[m], np.asarray(x)[m] * 2.0 + 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(out[~m], -5.0)


def test_masked_apply_multi_output_and_jit(rng):
    n = 2048
    mask = jnp.asarray(rng.rand(n) < 0.1)
    x = jnp.asarray(rng.rand(n).astype(np.float32))

    @jax.jit
    def go(mask, x):
        def fn(live, idx, xg):
            return xg + 1.0, (xg > 0.5)
        return masked_apply(mask, fn, (x,),
                            (jnp.zeros((n,)), jnp.zeros((n,), bool)),
                            bucket_caps(n, (1 / 8,)))

    a, b = go(mask, x)
    m = np.asarray(mask)
    np.testing.assert_allclose(np.asarray(a)[m], np.asarray(x)[m] + 1.0,
                               rtol=1e-6)
    assert (np.asarray(b)[m] == (np.asarray(x)[m] > 0.5)).all()
    assert not np.asarray(b)[~m].any()


def test_shade_full_compact_parity_wavefront():
    """compact=True must reproduce the uncompacted wavefront image
    exactly (same per-row math, XLA backend is per-ray independent)."""
    from tests.scenes import material_scene, W, H
    from voxel_tracer_tpu.models.camera import Camera, rays_for_image
    from voxel_tracer_tpu.renderer import RenderConfig, render_rays

    vol, scene = material_scene()
    sd = scene.data()
    cam = Camera.create((1.1, 0.9, -1.5), (0.0, 0.3, 0.0), W / H)
    o, d = rays_for_image(cam, W, H)
    base = RenderConfig(width=W, height=H, shading="full",
                        max_bounces=3, glass_reflections=2)
    ref = render_rays(sd, o, d, jnp.int32(7), config=base)
    out = render_rays(sd, o, d, jnp.int32(7),
                      config=RenderConfig(
                          width=W, height=H, shading="full",
                          max_bounces=3, glass_reflections=2,
                          compact=True, compact_fracs=(1 / 16, 1 / 4)))
    np.testing.assert_allclose(np.asarray(out["color"]),
                               np.asarray(ref["color"]),
                               rtol=1e-5, atol=1e-6)

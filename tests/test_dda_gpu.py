"""The traversal kernel's wrapper (`ops/pallas/dda_gpu.py`) and the choice
between the kernel and the XLA wavefront (`ops/dda.py`).

The kernel runs here in Pallas interpret mode; `gpu`-marked tests run the
compiled kernel and skip without a GPU.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.models.volume import VoxelVolume
from voxel_tracer_tpu.ops import dda


def _problem(n, seed=0, shape=(24, 24, 24)):
    vol = VoxelVolume.noise_filled(shape)
    rng = np.random.RandomState(seed)
    o = (rng.rand(n, 3) * 1.6 - 0.2).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return vol.data(), jnp.asarray(o), jnp.asarray(d)


def _both(data, o, d, **kw):
    a = dda.intersect_volume_local(data.grid, data.brick_occ, o, d, data.vpu,
                                   impl="xla", **kw)
    b = dda.intersect_volume_local(data.grid, data.brick_occ, o, d, data.vpu,
                                   impl="interpret", **kw)
    return a, b


def _assert_same(a, b):
    for k in ("t", "mat", "axis", "steps", "valid", "step_sign"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("n", [0, 1, 127, 129, 300])
def test_any_ray_count_is_padded(n):
    """N need not be a multiple of the block: the wrapper pads and slices
    back, and padded rows never leak into the result."""
    data, o, d = _problem(n)
    a, b = _both(data, o, d)
    assert np.asarray(b["t"]).shape == (n,)
    _assert_same(a, b)


def test_byte_tables_keep_high_ids_and_full_bricks():
    """The kernel reads material ids and brick occupancy as bytes: ids up
    to 255 come back unsigned, and a full brick (512 solid voxels, a count
    that does not fit a byte) still reads occupied."""
    g = np.zeros((16, 16, 16), np.uint8)
    g[0:8, 0:8, 0:8] = 255                  # one full brick, top id
    g[8:16, 8:16, 8:16] = 200
    vol = VoxelVolume(g, vpu=16.0)
    data = vol.data()
    assert int(np.asarray(data.brick_occ).max()) == 512
    o = jnp.asarray([[0.25, 0.25, -1.0], [0.75, 0.75, 2.0]], jnp.float32)
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]], jnp.float32)
    a, b = _both(data, o, d)
    _assert_same(a, b)
    assert list(np.asarray(b["mat"])) == [255, 200]


def test_default_impl_follows_backend():
    want = "triton" if jax.default_backend() == "gpu" else "xla"
    assert dda.default_impl() == want


def test_renderer_binds_impl_at_construction():
    """The traversal is part of the renderer's static config, so every
    frame of a renderer keeps the choice it was built with."""
    from tests.scenes import material_scene
    from voxel_tracer_tpu.renderer import RenderConfig, Renderer

    cfg = RenderConfig(width=16, height=8, shading="flat")
    r_kernel = Renderer(dataclasses.replace(cfg, traversal="interpret"))
    r_default = Renderer(cfg)
    assert r_kernel.config.traversal == "interpret"
    _, scene = material_scene()
    sd = scene.data()
    cam = r_kernel.camera((1.1, 0.9, -1.5), (0.0, 0.3, 0.0))
    a = r_kernel.render(sd, cam, frame=0)
    b = r_default.render(sd, cam, frame=0)
    assert _traversals(r_kernel._render, sd, cam, jnp.int32(0), None, None,
                       jnp.float32(0.0)) == (0, 1)
    np.testing.assert_array_equal(np.asarray(a["depth"]),
                                  np.asarray(b["depth"]))


def _traversals(fn, *args):
    """(wavefront loops, kernel calls) in the jaxpr of ``fn(*args)``; the
    loop inside each kernel is not counted."""
    counts = [0, 0]

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if name == "pallas_call":
                counts[1] += 1
                continue
            counts[0] += name == "while"
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (tuple, list)) else [v]):
                    sub = getattr(sub, "jaxpr", sub)
                    if hasattr(sub, "eqns"):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return tuple(counts)


@pytest.mark.parametrize("shading", ["flat", "lambert", "full"])
def test_traversal_choice_reaches_every_call(shading):
    """`RenderConfig.traversal` reaches every traversal of a frame —
    primary, shadow, medium, scan and continuation rays — and the default
    follows the backend."""
    import functools
    from tests.scenes import material_scene
    from voxel_tracer_tpu.models.camera import Camera
    from voxel_tracer_tpu.renderer import RenderConfig, _render_impl

    _, scene = material_scene()
    sd = scene.data()
    cam = Camera.create((1.1, 0.9, -1.5), (0.0, 0.3, 0.0), 2.0)
    counts = {}
    for impl in ("xla", "interpret", None):
        cfg = RenderConfig(width=16, height=8, shading=shading, max_bounces=3,
                           glass_reflections=2, traversal=impl)
        counts[impl] = _traversals(functools.partial(_render_impl,
                                                     config=cfg),
                                   sd, cam, jnp.int32(0))
    n = counts["xla"][0]
    assert n >= {"flat": 1, "lambert": 2, "full": 8}[shading]
    assert counts["xla"] == (n, 0)
    assert counts["interpret"] == (0, n)
    assert counts[None] == counts[dda.default_impl()]


def test_traversal_choice_reaches_diff_surface():
    from tests.scenes import material_scene
    from voxel_tracer_tpu.ops.diff_surface import palette_fit_loss

    _, scene = material_scene()
    sd = scene.data()
    data, o, d = _problem(64, seed=3)
    tgt = jnp.zeros((64, 3))
    pal = jnp.full((256, 3), 0.5)
    counts, grads = {}, {}
    for impl in ("xla", "interpret"):
        fn = jax.grad(lambda p: palette_fit_loss(p, sd, o - 0.5, d, tgt,
                                                 impl=impl))
        counts[impl] = _traversals(fn, pal)
        grads[impl] = np.asarray(fn(pal))
    assert counts["xla"] == (2, 0) and counts["interpret"] == (0, 2)
    np.testing.assert_array_equal(grads["interpret"], grads["xla"])


def test_traversal_choice_reaches_sharded_trace():
    """The ray-sharded trace runs the kernel inside `shard_map`, on each
    device's shard of the rays."""
    from tests.scenes import material_scene
    from voxel_tracer_tpu.parallel.mesh import make_ray_mesh
    from voxel_tracer_tpu.parallel.sharding import make_sharded_trace, \
        shard_rays
    from voxel_tracer_tpu.renderer import RenderConfig

    _, scene = material_scene()
    sd = scene.data()
    mesh = make_ray_mesh(2)
    _, o, d = _problem(256, seed=4)
    o, d = shard_rays(mesh, o - 0.5, d)
    hits = {}
    for impl in ("xla", "interpret"):
        fn = make_sharded_trace(mesh, RenderConfig(traversal=impl))
        counts = _traversals(fn, sd, o, d)
        assert counts == ((1, 0) if impl == "xla" else (0, 1)), counts
        hits[impl] = fn(sd, o, d)
    for a, b in zip(hits["xla"], hits["interpret"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_unknown_impl_is_refused():
    data, o, d = _problem(4)
    with pytest.raises(AssertionError):
        dda.intersect_volume_local(data.grid, data.brick_occ, o, d, data.vpu,
                                   impl="mosaic")


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 64, 64), (36, 44, 40)])
def test_compiled_kernel_matches_wavefront(gpu, shape):
    data, o, d = _problem(4096, seed=2, shape=shape)
    a = dda.intersect_volume_local(data.grid, data.brick_occ, o, d, data.vpu,
                                   impl="xla")
    b = dda.intersect_volume_local(data.grid, data.brick_occ, o, d, data.vpu,
                                   impl="triton")
    differ = np.zeros(4096, bool)
    for k in ("mat", "axis", "steps"):
        differ |= np.asarray(a[k]) != np.asarray(b[k])
    assert differ.mean() <= 1e-4
    ok = ~differ & (np.asarray(a["t"]) < 1e29)
    np.testing.assert_allclose(np.asarray(b["t"])[ok], np.asarray(a["t"])[ok],
                               rtol=1e-5)

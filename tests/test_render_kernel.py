"""`Renderer` frames with the traversal kernel (Pallas interpret mode) vs
the XLA wavefront: the shading code is shared, so the comparison isolates
the traversal backend — nearest hit, interior medium marches, scan rays
and the stochastic shadow rays of a full-material frame."""

import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from tests.scenes import W, H, material_scene
from voxel_tracer_tpu.models.camera import Camera
from voxel_tracer_tpu.renderer import RenderConfig, Renderer

FULL = RenderConfig(width=W, height=H, shading="full", max_bounces=3,
                    glass_reflections=2)


def _renderer(config, impl):
    return Renderer(dataclasses.replace(config, traversal=impl))


@pytest.fixture(scope="module")
def setup():
    _, scene = material_scene()
    sd = scene.data()
    cam = Camera.create((1.1, 0.9, -1.5), (0.0, 0.3, 0.0), W / H)
    kernel = _renderer(FULL, "interpret")
    frames = {impl: r.render(sd, cam, frame=7) for impl, r in
              (("interpret", kernel), ("xla", _renderer(FULL, "xla")))}
    return sd, cam, kernel, frames


def test_full_material_parity(setup):
    _, _, _, frames = setup
    for k in ("color", "depth", "normal", "material", "steps"):
        np.testing.assert_allclose(np.asarray(frames["interpret"][k]),
                                   np.asarray(frames["xla"][k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the scene must exercise both special material rows
    mats = np.asarray(frames["xla"]["material"]).reshape(-1)
    rows = set(np.floor((mats[mats > 0] - 1) / 8).astype(int))
    assert {0, 1} <= rows, f"glass+mirror not both visible: {rows}"


def test_glass_sees_pillar_through_wall(setup):
    """The diffuse pillar inside the glass box shows through the wall on
    the kernel path (medium march + scan continuation)."""
    _, _, _, frames = setup
    mats = np.asarray(frames["interpret"]["material"]).reshape(-1)
    assert (mats == 3).sum() > 20          # glass front faces hit
    img = np.asarray(frames["interpret"]["color"]).reshape(-1, 3)
    assert img[mats == 3].std() > 0.01


def test_accumulate_reduces_variance(setup):
    """Reprojection with the kernel (renderer.cpp:273-329): a static
    camera accumulating stochastic-shadow irradiance is steadier frame to
    frame than the raw single-frame output."""
    sd, cam, kernel, _ = setup
    cfg = RenderConfig(width=W, height=H, shading="full", max_bounces=2,
                       glass_reflections=1, accumulate=True)
    acc_r = _renderer(cfg, "interpret")
    raw, acc = [], []
    for f in range(5):
        acc.append(np.asarray(acc_r.render(sd, cam)["irradiance"]))
        raw.append(np.asarray(kernel.render(sd, cam, frame=f)["irradiance"]))
    d_acc = np.abs(acc[-1] - acc[-2]).mean()
    d_raw = np.abs(raw[-1] - raw[-2]).mean()
    assert d_acc < d_raw * 0.5, (d_acc, d_raw)
    # the renderer carries history across frames and can drop it
    assert acc_r.frame == 5 and acc_r._accu is not None
    acc_r.reset_history()
    assert acc_r._accu is None


def test_lambert_accumulate_fixed_point():
    """Deterministic lambert frames are identical, so blending 95%
    history is a fixed point: accumulated irradiance == raw irradiance on
    reprojected pixels."""
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.models.volume import VoxelVolume

    g = np.zeros((16, 16, 16), np.uint8)
    g[4:12, 4:12, 4:12] = 30
    sd = Scene(volumes=[VoxelVolume(g, vpu=20.0)]).data()
    w, h = 32, 16
    cam = Camera.create((1.2, 0.9, -1.4), (0, 0, 0), w / h)
    base = _renderer(RenderConfig(width=w, height=h, shading="lambert"),
                     "interpret").render(sd, cam, frame=0)
    acc_r = _renderer(RenderConfig(width=w, height=h, shading="lambert",
                                   accumulate=True), "interpret")
    for f in range(3):
        out = acc_r.render(sd, cam, frame=f)
    hit = np.asarray(base["depth"]) < 1e30
    np.testing.assert_allclose(np.asarray(out["irradiance"])[hit],
                               np.asarray(base["irradiance"])[hit],
                               rtol=1e-4, atol=1e-4)


def test_compact_parity_kernel(setup):
    """Live-ray compaction (RenderConfig.compact) with the kernel is a pure
    re-ordering: the compacted frame equals the uncompacted one."""
    sd, cam, _, _ = setup
    cfg = dict(width=W, height=H, shading="full", max_bounces=2,
               glass_reflections=1)
    ref = _renderer(RenderConfig(**cfg), "interpret").render(sd, cam, frame=3)
    out = _renderer(RenderConfig(**cfg, compact=True,
                                 compact_fracs=(1 / 4,)),
                    "interpret").render(sd, cam, frame=3)
    np.testing.assert_allclose(np.asarray(out["color"]),
                               np.asarray(ref["color"]), rtol=1e-5, atol=1e-6)


def test_multi_object_group_parity():
    """The default scene's drone group (4 objects, per-ray candidate
    `oid`) renders the same with the kernel as with the wavefront."""
    from voxel_tracer_tpu.utils.profiling import default_scene, default_camera

    scene, center = default_scene()
    sd = scene.data()
    assert max(g.grid.shape[0] for g in sd.groups) == 4
    cfg = RenderConfig(width=32, height=24, shading="lambert")
    cam = default_camera(center, 32 / 24)
    a = _renderer(cfg, "interpret").render(sd, cam, frame=0)
    b = _renderer(cfg, "xla").render(sd, cam, frame=0)
    for k in ("image", "depth", "material"):
        np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert (np.asarray(a["depth"]) < 1e29).mean() > 0.02

"""Benchmark suite on one GPU: one JSON line per cell.

`bench.py` is the single-line headline (flat primary rays/s at 1080p); this
suite covers the rest:

  flat_256_dense64       dense 64^3 noise @ 256^2, flat, primary rays only
  diff_lambert_512       512^2 rays through a sparse 64^3 density field
                         (`ops/diff.py`): forward and value_and_grad rays/s
  diff_surface_512       palette gradients through the Lambert shading of
                         the discrete hits (`ops/diff_surface.py`) @ 512^2
  vox_brickmap_720p      .vox crate asset, lambert @ 1280x768
  multiobj_shadow_1080p  512-crate profiling scene baked to one grid,
                         lambert (primary + sun shadow ray) @ 1920x1088
  full_whitted_720p      default frame (glass box + 4 drones, sphere
                         light), full materials, 3 bounces / 2 glass
                         reflections @ 1280x768
  full_whitted_refdepth  the same at the reference depth (8 / 8)
  inverse_128_32views    `Trainer` step, 128^3 grid, 32 posed 64x64 views,
                         131,072 rays/step

Every cell runs in this one process through `Renderer`, `Trainer` or the
differentiable ops, and times a steady window after warm-up that ends in
`jax.block_until_ready`.  Every line names the platform, device kind,
device count and power limit.  Fails when JAX finds no GPU.

    python bench_suite.py [cell ...]
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402


def _frames(config, sd, cam, iters):
    from voxel_tracer_tpu.renderer import Renderer
    from voxel_tracer_tpu.utils.timer import device_time

    r = Renderer(config)
    dt, _ = device_time(lambda: r.render(sd, cam, frame=0), iters=iters)
    return dt


def _frame_result(metric, config, dt, rays_per_px=1):
    return {"metric": metric,
            "value": rays_per_px * config.width * config.height / dt,
            "unit": "rays/s", "frames_per_s": 1.0 / dt}


def bench_flat_256():
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.models.skydome import SkyDome
    from voxel_tracer_tpu.renderer import RenderConfig
    from voxel_tracer_tpu.utils.profiling import noise_camera, noise_volume

    cfg = RenderConfig(width=256, height=256, shading="flat")
    sd = Scene(volumes=[noise_volume()],
               skydome=SkyDome.procedural(64, 32)).data()
    dt = _frames(cfg, sd, noise_camera(1.0), 200)
    return _frame_result("flat_256_dense64", cfg, dt)


def _diff_scene():
    """Sparse Gaussian-blob density (exact zeros outside, ~15% occupied)
    and 512^2 parallel rays through it, in the grid's local frame."""
    import jax
    import jax.numpy as jnp

    n, g = 512 * 512, 64
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    zz, yy, xx = jnp.meshgrid(*[jnp.linspace(0, 1, g)] * 3, indexing="ij")
    blob = 40.0 * jnp.exp(-((xx - 0.5) ** 2 + (yy - 0.5) ** 2
                            + (zz - 0.5) ** 2) * 60.0)
    sigma = jnp.where(blob > 0.05,
                      jax.random.uniform(k1, (g, g, g)) * blob * 0.25, 0.0)
    albedo = jax.random.uniform(k2, (g, g, g, 3))
    u = jax.random.uniform(k3, (n, 2)) * (g / 20.0)
    o_l = jnp.stack([u[:, 0], u[:, 1], jnp.full((n,), -0.5)], axis=1)
    d0 = jnp.array([0.15, 0.1, 1.0])
    d_l = jnp.broadcast_to(d0 / jnp.linalg.norm(d0), (n, 3))
    return n, sigma, albedo, o_l, d_l


def bench_diff_lambert_512():
    import jax
    import jax.numpy as jnp
    from voxel_tracer_tpu.ops import diff
    from voxel_tracer_tpu.utils.timer import device_time

    n, sigma, albedo, o_l, d_l = _diff_scene()
    target = jnp.zeros((n, 3))

    @jax.jit
    def fwd(s, a):
        return diff.render_density(s, a, o_l, d_l, 20.0, 128)["color"]

    @jax.jit
    def bwd(s, a):
        def loss(s, a):
            out = diff.render_density(s, a, o_l, d_l, 20.0, 128)
            return jnp.mean((out["color"] - target) ** 2)
        return jax.value_and_grad(loss, argnums=(0, 1))(s, a)

    dt_f, _ = device_time(fwd, sigma, albedo, iters=20)
    dt_b, _ = device_time(bwd, sigma, albedo, iters=20)
    return {"metric": "diff_lambert_512", "value": n / dt_b,
            "unit": "bwd_rays/s", "fwd_rays_per_s": n / dt_f}


def bench_diff_surface_512():
    import jax
    import jax.numpy as jnp
    from voxel_tracer_tpu.models.camera import rays_for_image
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.ops.diff_surface import palette_fit_loss
    from voxel_tracer_tpu.utils.profiling import noise_camera, noise_volume
    from voxel_tracer_tpu.utils.timer import device_time

    w = h = 512
    sd = Scene(volumes=[noise_volume()]).data()
    o, d = rays_for_image(noise_camera(1.0), w, h)
    tgt = jnp.zeros((w * h, 3))
    grad = jax.jit(jax.grad(lambda p: palette_fit_loss(p, sd, o, d, tgt)))
    dt, _ = device_time(grad, jnp.full((256, 3), 0.5), iters=20)
    return {"metric": "diff_surface_512", "value": w * h / dt,
            "unit": "bwd_rays/s"}


def bench_vox_brickmap():
    from voxel_tracer_tpu.models.assets import asset_path
    from voxel_tracer_tpu.models.camera import Camera
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.models.skydome import SkyDome
    from voxel_tracer_tpu.models.volume import VoxelVolume
    from voxel_tracer_tpu.renderer import RenderConfig

    cfg = RenderConfig(width=1280, height=768, shading="lambert")
    vol = VoxelVolume.from_vox(asset_path("crate-16.vox"))
    sd = Scene(volumes=[vol], skydome=SkyDome.procedural(64, 32)).data()
    cam = Camera.create((1.6, 1.1, -1.6), (0.0, 0.0, 0.0), cfg.aspect)
    dt = _frames(cfg, sd, cam, 50)
    return _frame_result("vox_brickmap_720p", cfg, dt, rays_per_px=2)


def bench_multiobj_shadow():
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.models.skydome import SkyDome
    from voxel_tracer_tpu.renderer import RenderConfig
    from voxel_tracer_tpu.utils.profiling import (profiling_camera,
                                                  profiling_scene_merged)

    cfg = RenderConfig(width=1920, height=1088, shading="lambert")
    sd = Scene(volumes=[profiling_scene_merged()],
               skydome=SkyDome.procedural(64, 32)).data()
    dt = _frames(cfg, sd, profiling_camera(cfg.aspect), 30)
    return _frame_result("multiobj_shadow_1080p", cfg, dt, rays_per_px=2)


def bench_full_whitted(metric="full_whitted_720p", bounces=3, glass_refl=2,
                       frames=10):
    """The reference's default frame with every material; `value` counts
    primary rays/s (frames/s x W x H)."""
    from voxel_tracer_tpu.renderer import RenderConfig
    from voxel_tracer_tpu.utils.profiling import default_camera, default_scene

    cfg = RenderConfig(width=1280, height=768, shading="full",
                       max_bounces=bounces, glass_reflections=glass_refl)
    scene, center = default_scene()
    dt = _frames(cfg, scene.data(), default_camera(center, cfg.aspect),
                 frames)
    r = _frame_result(metric, cfg, dt)
    r["config"] = {"bounces": bounces, "glass_reflections": glass_refl}
    return r


def bench_full_whitted_refdepth():
    # reference recursion depth: 8 bounces + 8 internal reflections
    # (materials.cpp:16,128)
    return bench_full_whitted("full_whitted_refdepth_720p", 8, 8, frames=4)


def bench_inverse_128():
    import jax
    import jax.numpy as jnp
    from voxel_tracer_tpu.trainer import TrainConfig, Trainer
    from voxel_tracer_tpu.utils.profiling import TrainShape, training_problem
    from voxel_tracer_tpu.utils.timer import device_time

    s = TrainShape()
    g = s.grid
    vpu, o, d, c = training_problem(g, s.views, s.view_px, 3 * g)
    tr = Trainer(TrainConfig(grid_size=(g, g, g), vpu=vpu,
                             rays_per_batch=s.rays, march_steps=3 * g))
    idx = np.random.RandomState(1).randint(0, len(o), s.rays)
    batch = [jnp.asarray(a[idx], jnp.float32) for a in (o, d, c)]
    state = [tr.params, tr.opt_state]

    def step():
        state[0], state[1], loss = tr.step_fn(state[0], state[1], *batch)
        return loss

    dt, _ = device_time(step, iters=20)
    return {"metric": "inverse_128_32views", "value": 1.0 / dt,
            "unit": "train_steps/s", "bwd_rays_per_s": s.rays / dt,
            "rays_per_step": s.rays}


BENCHES = {
    "flat_256": bench_flat_256,
    "diff_lambert_512": bench_diff_lambert_512,
    "diff_surface_512": bench_diff_surface_512,
    "vox_brickmap": bench_vox_brickmap,
    "multiobj_shadow": bench_multiobj_shadow,
    "full_whitted": bench_full_whitted,
    "full_whitted_refdepth": bench_full_whitted_refdepth,
    "inverse_128": bench_inverse_128,
}


def main(argv):
    from voxel_tracer_tpu.utils import compile_cache

    compile_cache.enable()
    from voxel_tracer_tpu.utils.device import device_record, require_gpu

    require_gpu()
    record = device_record()
    for name in argv or list(BENCHES):
        print(json.dumps({**BENCHES[name](), **record}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])

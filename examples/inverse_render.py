"""Inverse rendering (the 128^3 / 32-view training workload, scaled-down
CLI demo).

Optimizes a density+albedo grid from posed renderings of a synthetic target
volume, ray-sharded over the available device mesh with gradient psum.

Usage:
    python examples/inverse_render.py [--grid 32] [--views 16] [--steps 150]
                                      [--size 64] [--out recon.png]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def make_target_views(grid_n, n_views, img_size, vpu):
    """Render ground-truth views of a synthetic colored-blob volume."""
    import jax.numpy as jnp

    from voxel_tracer_tpu.models.camera import Camera, rays_for_image
    from voxel_tracer_tpu.ops import diff

    z, y, x = np.meshgrid(*[np.arange(grid_n)] * 3, indexing="ij")
    c = (grid_n - 1) / 2
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    sigma = np.where(r < grid_n * 0.35, 8.0, 0.0).astype(np.float32)
    albedo = np.zeros((grid_n,) * 3 + (3,), np.float32)
    albedo[..., 0] = x / grid_n
    albedo[..., 1] = y / grid_n
    albedo[..., 2] = 1.0 - x / grid_n

    sigma_t = jnp.asarray(sigma)
    albedo_t = jnp.asarray(albedo)
    pivot = np.full(3, grid_n / (2 * vpu), np.float32)

    views = []
    for vi in range(n_views):
        ang = 2 * np.pi * vi / n_views
        el = 0.35 * np.sin(ang * 2 + 1.0)
        pos = 1.6 * np.array([np.cos(ang) * np.cos(el),
                              np.sin(el),
                              np.sin(ang) * np.cos(el)])
        cam = Camera.create(pos, (0, 0, 0), 1.0)
        o, d = rays_for_image(cam, img_size, img_size)
        out = diff.render_density(sigma_t, albedo_t, o + pivot, d, vpu, 128)
        img = np.asarray(out["color"])
        views.append((np.asarray(o) + pivot, np.asarray(d), img))
    return views, (sigma, albedo)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--out", default="recon.png")
    ap.add_argument("--ckpt", default=None)
    args = ap.parse_args()

    from voxel_tracer_tpu.utils import compile_cache

    compile_cache.enable()
    from voxel_tracer_tpu.models.camera import Camera, rays_for_image
    from voxel_tracer_tpu.trainer import TrainConfig, Trainer
    from voxel_tracer_tpu.utils.framebuffer import write_png
    from voxel_tracer_tpu.ops import diff
    import jax.numpy as jnp

    vpu = float(args.grid)  # unit cube
    print(f"rendering {args.views} target views of a {args.grid}^3 volume...")
    views, (gt_sigma, gt_albedo) = make_target_views(
        args.grid, args.views, args.size, vpu)

    origins = np.concatenate([v[0] for v in views]).astype(np.float32)
    dirs = np.concatenate([v[1] for v in views]).astype(np.float32)
    targets = np.concatenate([v[2] for v in views]).astype(np.float32)

    cfg = TrainConfig(grid_size=(args.grid,) * 3, vpu=vpu, lr=args.lr,
                      steps=args.steps, rays_per_batch=args.rays,
                      march_steps=3 * args.grid,
                      checkpoint_dir=args.ckpt)
    trainer = Trainer(cfg)
    if trainer.maybe_restore():
        print(f"resumed from step {trainer.step}")

    t0 = time.perf_counter()
    trainer.fit(origins, dirs, targets, log_every=max(args.steps // 10, 1))
    print(f"trained {trainer.step} steps in {time.perf_counter() - t0:.1f}s "
          f"on {trainer.mesh.devices.size} device(s)")

    # held-out view PSNR
    cam = Camera.create((1.35, 0.55, 0.9), (0, 0, 0), 1.0)
    o, d = rays_for_image(cam, args.size, args.size)
    pivot = np.full(3, args.grid / (2 * vpu), np.float32)
    out = diff.render_density(jnp.asarray(gt_sigma), jnp.asarray(gt_albedo),
                              o + pivot, d, vpu, cfg.march_steps)
    gt_img = np.asarray(out["color"]).reshape(args.size, args.size, 3)
    recon = trainer.render(cam, args.size, args.size)
    mse = float(np.mean((recon - gt_img) ** 2))
    psnr = -10 * np.log10(max(mse, 1e-10))
    print(f"held-out view PSNR: {psnr:.2f} dB")

    side = np.concatenate([gt_img, recon], axis=1)
    write_png(args.out, np.clip(side, 0, 1))
    print(f"wrote {args.out} (left: target, right: reconstruction)")
    return 0 if psnr > 20 else 1


if __name__ == "__main__":
    sys.exit(main())

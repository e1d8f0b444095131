"""Scaling-efficiency harness: rays/s and train-step/s vs device count.

Measures the ray-sharded forward trace and the psum-all-reduced train step
(parallel/sharding.py) at 1, 2, 4, 8 devices and reports efficiency
percentages vs the 1-device run.

It spawns one CPU-only subprocess per device count with
`--xla_force_host_platform_device_count=N` (virtual CPU devices on a
shared host): the numbers then measure SHARDING + COLLECTIVE OVERHEAD
(partitioned compile, psum, resharding), not hardware scaling — on an
M-core host, N > M virtual devices time-share cores, so raw efficiency
percentages are a lower bound.  Results land in
chiprun_out/SCALING.json (not committed).

Usage:
  python tools/scaling.py                 # full sweep -> chiprun_out/
  python tools/scaling.py --worker 4      # one measurement (internal)
"""
import argparse
import json
import os
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)

TRACE_RAYS = 512 * 512
TRACE_REPS = 8
GRID = 64
TRAIN_RAYS = 512 * 1024  # large batch: amortizes the fixed full-grid grad psum
MAX_STEPS = 128


def worker(n_dev: int):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count={n_dev}").strip()
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR",
                          os.path.join(_ROOT, ".jax_cache"))
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "1")

    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    jax.config.update("jax_platforms", "cpu")
    from voxel_tracer_tpu.models.camera import Camera, rays_for_image
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.models.volume import VoxelVolume
    from voxel_tracer_tpu.parallel.mesh import make_ray_mesh
    from voxel_tracer_tpu.parallel import sharding

    assert len(jax.devices()) == n_dev, jax.devices()
    mesh = make_ray_mesh()

    # --- forward trace: rays sharded, scene replicated -----------------
    vol = VoxelVolume.noise_filled((GRID,) * 3, vpu=20.0)
    scene = Scene(volumes=[vol]).data()
    cam = Camera.create((2.0, 1.4, -2.4), (0, 0, 0), 1.0)
    o, d = rays_for_image(cam, 512, 512)
    o, d = sharding.shard_rays(mesh, o, d)

    from voxel_tracer_tpu.renderer import RenderConfig
    trace = sharding.make_sharded_trace(
        mesh, RenderConfig(width=512, height=512))
    hit = trace(scene, o, d)
    jax.block_until_ready(hit.t)
    t0 = time.perf_counter()
    for _ in range(TRACE_REPS):
        hit = trace(scene, o, d)
    jax.block_until_ready(hit.t)
    dt_trace = (time.perf_counter() - t0) / TRACE_REPS

    # --- train step: grads psum'd over the mesh ------------------------
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 4)
    params = {"sigma": jax.random.uniform(ks[0], (GRID,) * 3),
              "albedo": jax.random.uniform(ks[1], (GRID,) * 3 + (3,))}
    opt = optax.adam(1e-2)
    opt_state = opt.init(params)
    o_l = jax.random.uniform(ks[2], (TRAIN_RAYS, 3)) * (GRID / 20.0)
    o_l = o_l.at[:, 2].set(-0.5)
    d0 = jnp.array([0.1, 0.05, 1.0]); d0 = d0 / jnp.linalg.norm(d0)
    d_l = jnp.broadcast_to(d0, (TRAIN_RAYS, 3))
    target = jax.random.uniform(ks[3], (TRAIN_RAYS, 3))
    step = sharding.make_train_step(mesh, opt, 20.0, MAX_STEPS)

    params, opt_state, loss = step(params, opt_state, o_l, d_l, target)
    jax.block_until_ready(loss)
    t0 = time.perf_counter()
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, o_l, d_l, target)
    jax.block_until_ready(loss)
    dt_train = (time.perf_counter() - t0) / 3

    # identical local compute WITHOUT the gradient pmean: the ratio
    # isolates collective overhead from virtual-device core time-sharing
    step_ns = sharding.make_train_step(mesh, opt, 20.0, MAX_STEPS,
                                       sync_grads=False)
    p2, st2, l2 = step_ns(params, opt_state, o_l, d_l, target)
    jax.block_until_ready(l2)
    t0 = time.perf_counter()
    for _ in range(3):
        p2, st2, l2 = step_ns(params, opt_state, o_l, d_l, target)
    jax.block_until_ready(l2)
    dt_nosync = (time.perf_counter() - t0) / 3

    # overlapped variant: per-slab grad pmean issued inside the backward
    # (make_train_step(overlap_slabs=8)) vs the same compute without sync
    def time_step(st_fn):
        p3, s3, l3 = st_fn(params, opt_state, o_l, d_l, target)
        jax.block_until_ready(l3)
        t0 = time.perf_counter()
        for _ in range(3):
            p3, s3, l3 = st_fn(params, opt_state, o_l, d_l, target)
        jax.block_until_ready(l3)
        return (time.perf_counter() - t0) / 3

    # slab_max_steps: this harness's ray batch is z-dominant (a ray
    # crosses ~1.15 cells per z layer), so a slab's in-slab visit count
    # is ~10 of its 8 layers; 16 keeps the slab decomposition's total
    # march work equal to the plain step's 128
    dt_ov = time_step(sharding.make_train_step(
        mesh, opt, 20.0, MAX_STEPS, overlap_slabs=8,
        slab_max_steps=MAX_STEPS // 8))
    dt_ov_ns = time_step(sharding.make_train_step(
        mesh, opt, 20.0, MAX_STEPS, overlap_slabs=8,
        slab_max_steps=MAX_STEPS // 8, sync_grads=False))

    print(json.dumps({
        "n_devices": n_dev,
        "trace_rays_per_s": round(TRACE_RAYS / dt_trace),
        "train_steps_per_s": round(1.0 / dt_train, 3),
        "train_bwd_rays_per_s": round(TRAIN_RAYS / dt_train),
        "collective_efficiency_pct": round(100.0 * dt_nosync / dt_train,
                                           1),
        "train_overlap_steps_per_s": round(1.0 / dt_ov, 3),
        "collective_efficiency_overlap_pct": round(
            100.0 * dt_ov_ns / dt_ov, 1),
    }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--devices", type=str, default="1,2,4,8")
    args = ap.parse_args()
    if args.worker:
        worker(args.worker)
        return

    results = []
    ncpu_ = os.cpu_count()
    for n in [int(x) for x in args.devices.split(",")]:
        # pin the worker to min(n, ncpu) cores: an UNPINNED 1-device run
        # lets XLA's intra-op threads use every core, inflating the
        # baseline and deflating every efficiency percentage — pinning
        # makes "N devices on N cores" the like-for-like comparison
        cores = min(n, ncpu_)
        pin = ["taskset", "-c", ",".join(str(c) for c in range(cores))]
        out = subprocess.run(
            pin + [sys.executable, os.path.abspath(__file__),
                   "--worker", str(n)],
            capture_output=True, text=True, cwd=_ROOT, timeout=3600)
        line = [l for l in out.stdout.splitlines() if l.startswith("{")]
        if not line:
            results.append({"n_devices": n, "error": out.stderr[-300:]})
            print(json.dumps(results[-1]), flush=True)
            continue
        results.append(json.loads(line[-1]))
        print(json.dumps(results[-1]), flush=True)

    base = next((r for r in results if r.get("n_devices") == 1
                 and "error" not in r), None)
    ncpu = os.cpu_count()
    if base:
        for r in results:
            if "error" in r:
                continue
            n = r["n_devices"]
            r["trace_efficiency_pct"] = round(
                100.0 * r["trace_rays_per_s"]
                / (base["trace_rays_per_s"] * n), 1)
            r["train_efficiency_pct"] = round(
                100.0 * r["train_bwd_rays_per_s"]
                / (base["train_bwd_rays_per_s"] * n), 1)
            # normalize by the cores actually granted (devices beyond the
            # core count time-share): the fair sharding-overhead metric
            cores = min(n, ncpu)
            r["trace_core_efficiency_pct"] = round(
                100.0 * r["trace_rays_per_s"]
                / (base["trace_rays_per_s"] * cores), 1)
            r["train_core_efficiency_pct"] = round(
                100.0 * r["train_bwd_rays_per_s"]
                / (base["train_bwd_rays_per_s"] * cores), 1)
    doc = {"note": ("virtual CPU devices, each worker pinned to "
                    f"min(n, {ncpu}) host cores; *_core_efficiency_pct "
                    "normalizes by granted cores (the fair "
                    "sharding+collective-overhead metric), plain "
                    "*_efficiency_pct by device count (a lower bound "
                    "once devices time-share cores); "
                    "collective_efficiency_pct isolates the psum cost "
                    "(same compute with sync_grads off)"),
           "results": results}
    out_dir = os.path.join(_ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "SCALING.json"), "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps({"wrote": "chiprun_out/SCALING.json"}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Smoke run of the main path on one GPU.

Drives the renderer and the inverse-rendering trainer through their public
entry points at full width, compares the Triton traversal kernel with the
XLA wavefront and the scalar oracle, and prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases (each a function below): device, traversal, frames, training.
``--devices 4`` runs only the four-card mesh phase and its one-card
comparison.  ``--cpu`` runs the phases on the CPU at tiny sizes with the
kernel in Pallas interpret mode (used by the tests); it never prints the
result line.

    python chip_smoke.py                 # one GPU: the main path
    python chip_smoke.py --devices 4     # four GPUs, the mesh phase
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from voxel_tracer_tpu.utils.profiling import TrainShape  # noqa: E402

# Traversal parity bounds (kernel vs wavefront, kernel vs oracle): rays
# whose hit flag, material, axis or step count differ may make up at most
# this fraction (an FMA contraction can flip a crossing-t tie); on the rays
# that agree, t matches to this relative tolerance.
MAX_DIFFER_FRAC = 1e-4
T_RTOL = 1e-5
GRAD_RTOL = 1e-4   # relative L2 of gradients, GPU vs CPU / 4 cards vs 1


@dataclasses.dataclass(frozen=True)
class Sizes:
    lambert_hw: tuple = (1088, 1920)
    full_hw: tuple = (768, 1280)
    crates_per_axis: int = 8
    oracle_rays: int = 4096
    frames: int = 3
    train: TrainShape = TrainShape()
    train_steps: int = 5
    grad_grid: int = 64
    grad_rays: int = 8192


TINY = Sizes(lambert_hw=(24, 32), full_hw=(16, 24), crates_per_axis=2,
             oracle_rays=48, frames=1,
             train=TrainShape(grid=16, views=4, view_px=16, rays=512),
             train_steps=3, grad_grid=16, grad_rays=256)

# hit fraction bounds of each main-path frame scene
HIT_BOUNDS = {"lambert_noise64": (0.2, 0.999),
              "full_default_scene": (0.05, 0.95)}


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------- device --

def phase_device(cpu: bool):
    import jax
    from voxel_tracer_tpu.utils.device import card_line, require_gpu

    dev = jax.devices()[0]
    log(f"jax {jax.__version__}: {len(jax.devices())} x {dev.platform} "
        f"({dev.device_kind})")
    if cpu:
        return dev
    require_gpu()
    log(card_line())
    return dev


# ------------------------------------------------------------- traversal --

def _local_rays(vol, origins, dirs):
    """World rays -> the volume's local frame (composite._to_local)."""
    import jax.numpy as jnp
    from voxel_tracer_tpu.ops.composite import _to_local

    d = vol.data()
    return _to_local(d.rot, d.pos, d.pivot, jnp.asarray(origins, jnp.float32),
                     jnp.asarray(dirs, jnp.float32))


def compare_hits(label, ref, got, t_rtol=T_RTOL, max_frac=MAX_DIFFER_FRAC):
    """Assert two traversal results agree within the parity bounds."""
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: np.asarray(v) for k, v in got.items()}
    hit_r, hit_g = ref["t"] < 1e29, got["t"] < 1e29
    differ = (hit_r != hit_g)
    for k in ("mat", "axis", "steps"):
        if k in ref and k in got:
            differ |= ref[k] != got[k]
    both = hit_r & ~differ
    scale = np.maximum(np.abs(ref["t"][both]), 1e-6)
    t_err = float(np.max(np.abs(got["t"][both] - ref["t"][both]) / scale,
                         initial=0.0))
    frac = float(differ.mean())
    log(f"  {label}: {differ.size} rays, hit {hit_r.mean():.4f}, differ "
        f"{int(differ.sum())} ({frac:.2e}), max t rel err {t_err:.2e}")
    assert frac <= max_frac, f"{label}: {frac:.2e} of rays differ"
    assert t_err <= t_rtol, f"{label}: t rel err {t_err:.2e}"


def _trace_both(kernel_impl, vol, o_l, d_l, **kw):
    from voxel_tracer_tpu.ops import dda

    d = vol.data()
    out = {}
    for impl in ("xla", kernel_impl):
        res = dda.intersect_volume_local(d.grid, d.brick_occ, o_l, d_l, d.vpu,
                                         impl=impl, **kw)
        out[impl] = {k: res[k] for k in ("t", "mat", "axis", "steps")}
    return out["xla"], out[kernel_impl]


def _oracle_check(label, vol, origins, dirs, got, n, seeds=None):
    """Compare a random ``n``-ray subsample with the scalar oracle (shadow
    semantics when per-ray ``seeds`` are given)."""
    from voxel_tracer_tpu.ops import oracle

    ov = oracle.OracleVolume(grid=vol.grid, vpu=vol.vpu, pos=vol.pos,
                             rot=vol.rot)
    idx = np.random.RandomState(0).choice(len(origins), n, replace=False)
    ref = {"t": [], "mat": [], "axis": []}
    for i in idx:
        kw = {} if seeds is None else dict(shadow=True, seed=int(seeds[i]))
        h = oracle.intersect_volume(ov, origins[i], dirs[i], **kw)
        ref["t"].append(h.depth)
        ref["mat"].append(h.material)
        ref["axis"].append(int(np.argmax(np.abs(vol.rot.T @ h.normal))))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    sub = {k: np.asarray(got[k])[idx] for k in ("t", "mat", "axis")}
    # the oracle reports a normal only on hits, and counts the step that
    # leaves the grid differently, so steps and miss axes are not compared
    for r in (ref, sub):
        r["axis"] = np.where(r["t"] < 1e29, r["axis"], 0)
    compare_hits(label, ref, sub)


def phase_traversal(sizes: Sizes, kernel_impl: str):
    import jax
    import jax.numpy as jnp
    from voxel_tracer_tpu.models.camera import rays_for_image
    from voxel_tracer_tpu.models.scene import SUN_DIR
    from voxel_tracer_tpu.models.volume import bake_aligned_scene
    from voxel_tracer_tpu.utils import profiling

    h, w = sizes.lambert_hw
    # 1. primary rays on the dense 64^3 noise volume
    vol = profiling.noise_volume()
    o, d = rays_for_image(profiling.noise_camera(w / h), w, h)
    o_l, d_l = _local_rays(vol, o, d)
    ref, got = _trace_both(kernel_impl, vol, o_l, d_l)
    compare_hits(f"noise64 primary {w}x{h}", ref, got)
    _oracle_check(f"noise64 oracle {sizes.oracle_rays}", vol, np.asarray(o),
                  np.asarray(d), got, sizes.oracle_rays)
    if kernel_impl == "triton":
        from voxel_tracer_tpu.ops.pallas import dda_gpu
        lowered = jax.jit(lambda a, b: dda_gpu.trace(
            vol.data().grid, vol.data().brick_occ, a, b, 20.0,
            jnp.zeros(a.shape[:1]), jnp.zeros(a.shape[:1]),
            jnp.zeros(a.shape[:1], jnp.int32),
            jnp.ones(a.shape[:1], jnp.int32), max_steps=256)).lower(o_l, d_l)
        log(f"  kernel memory: {lowered.compile().memory_analysis()}")

    # 2. primary + sun shadow rays on the 512-crate scene, baked to one grid
    crates = bake_aligned_scene(
        profiling.profiling_volumes(sizes.crates_per_axis))
    cam = profiling.profiling_camera(w / h, sizes.crates_per_axis)
    o, d = rays_for_image(cam, w, h)
    o_l, d_l = _local_rays(crates, o, d)
    ref, got = _trace_both(kernel_impl, crates, o_l, d_l)
    compare_hits(f"crates {crates.grid.shape} primary", ref, got)
    t = np.asarray(ref["t"])
    hit = t < 1e29
    p_l = np.asarray(o_l) + np.asarray(d_l) * np.where(hit, t, 0.0)[:, None]
    # shadow origins pulled back off the surface (ops.shading.hit_point);
    # the profiling camera faces the sun, so a second set of shadow rays
    # goes toward the sun mirrored in x and z, into the crate field
    p_l = jnp.asarray((p_l - np.asarray(d_l) * 1e-4)[hit])
    for name, sun in (("sun", SUN_DIR), ("back-sun", SUN_DIR * [-1, 1, -1])):
        sun = jnp.asarray(np.broadcast_to(sun, p_l.shape), jnp.float32)
        ref, got = _trace_both(kernel_impl, crates, p_l, sun)
        compare_hits(f"crates {name} shadow", ref, got)

    # 3. medium / ignore / shadow variants through the glass box, fed by
    #    the hit points of one full-material frame
    scene, center = profiling.default_scene()
    hf, wf = sizes.full_hw
    from voxel_tracer_tpu.renderer import RenderConfig, Renderer
    r = Renderer(RenderConfig(width=wf, height=hf, shading="full",
                              max_bounces=3, glass_reflections=2,
                              traversal="xla"))
    cam = profiling.default_camera(center, wf / hf)
    frame = r.render(scene.data(), cam, frame=0)
    o, d = rays_for_image(cam, wf, hf)
    box = scene.volumes[0]
    depth = np.asarray(frame["depth"]).reshape(-1)
    mat = np.asarray(frame["material"]).reshape(-1)
    o, d = np.asarray(o), np.asarray(d)
    hit_px = (depth < 1e29)
    p = o + d * np.where(hit_px, depth, 0.0)[:, None]
    o_l, d_l = _local_rays(box, p[hit_px] + d[hit_px] * 1e-4, d[hit_px])
    m = mat[hit_px]
    n = len(m)
    medium = jnp.asarray(np.where((m >= 1) & (m <= 8), m, 4), jnp.int32)
    ref, got = _trace_both(kernel_impl, box, o_l, d_l, medium=medium)
    compare_hits(f"box medium ({n} frame hits)", ref, got)
    ignore = jnp.asarray(np.where(m > 0, m, 0), jnp.int32)
    ref, got = _trace_both(kernel_impl, box, o_l, d_l, ignore=ignore)
    compare_hits("box ignore", ref, got)
    light = np.asarray(scene.lights[0].origin)
    ls = light - (p[hit_px] - d[hit_px] * 1e-4)
    ls /= np.linalg.norm(ls, axis=1, keepdims=True)
    ls_o, ls_d = _local_rays(box, p[hit_px] - d[hit_px] * 1e-4, ls)
    seed = jnp.asarray(np.random.RandomState(3).randint(
        0, 2 ** 31, n).astype(np.uint32))
    ref, got = _trace_both(kernel_impl, box, ls_o, ls_d, shadow=True,
                           shadow_seed=seed)
    compare_hits("box light shadow", ref, got)
    k = min(sizes.oracle_rays, n)
    _oracle_check(f"box shadow oracle {k}", box,
                  p[hit_px] - d[hit_px] * 1e-4, ls, got, k,
                  seeds=np.asarray(seed))


# ---------------------------------------------------------------- frames --

def _time_frames(renderer, scene_data, cam, frames):
    import jax

    t0 = time.perf_counter()
    for i in range(frames):
        out = renderer.render(scene_data, cam, frame=i)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / frames


def phase_frames(sizes: Sizes, kernel_impl: str):
    import jax
    from voxel_tracer_tpu.renderer import Renderer
    from voxel_tracer_tpu.utils import profiling

    results = {}
    for name, config, sd, cam in profiling.frame_scenes(sizes.lambert_hw,
                                                        sizes.full_hw):
        lo, hi = HIT_BOUNDS[name]
        renderers = {}
        for impl in (kernel_impl, "xla"):
            renderers[impl] = Renderer(dataclasses.replace(config,
                                                           traversal=impl))
            t0 = time.perf_counter()
            out = jax.block_until_ready(renderers[impl].render(sd, cam,
                                                               frame=0))
            img = np.asarray(out["image"])
            hit = float((np.asarray(out["depth"]) < 1e29).mean())
            log(f"  {name} [{impl}]: first frame {time.perf_counter() - t0:.1f}"
                f" s (compile), hit fraction {hit:.4f}, mean {img.mean():.4f}")
            assert img.shape == (config.height, config.width, 3)
            assert np.isfinite(img).all(), f"{name} [{impl}]: non-finite image"
            assert lo <= hit <= hi, f"{name} [{impl}]: hit fraction {hit}"
        times = {impl: [] for impl in renderers}
        for impl in (kernel_impl, "xla", "xla", kernel_impl):
            times[impl].append(_time_frames(renderers[impl], sd, cam,
                                            sizes.frames))
        fps = {impl: 1.0 / float(np.mean(v)) for impl, v in times.items()}
        log(f"  {name} {config.width}x{config.height}: frames/s kernel "
            f"{fps[kernel_impl]:.3f} ({times[kernel_impl]}), xla "
            f"{fps['xla']:.3f} ({times['xla']})")
        results[name] = fps
    return results


# -------------------------------------------------------------- training --

def _grad_fn(vpu, march_steps):
    import jax
    import jax.numpy as jnp
    from voxel_tracer_tpu.ops import diff

    def loss(params, o, d, c):
        out = diff.render_density(params["sigma"], params["albedo"], o, d,
                                  vpu, march_steps)
        return jnp.mean((out["color"] - c) ** 2)

    return jax.jit(jax.value_and_grad(loss))


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def phase_training(sizes: Sizes):
    import jax
    import jax.numpy as jnp
    from voxel_tracer_tpu.trainer import TrainConfig, Trainer
    from voxel_tracer_tpu.utils.profiling import training_problem

    ts = sizes.train
    g = ts.grid
    steps = 3 * g
    vpu, o, d, c = training_problem(g, ts.views, ts.view_px, steps)
    cfg = TrainConfig(grid_size=(g, g, g), vpu=vpu, steps=sizes.train_steps,
                      rays_per_batch=ts.rays, march_steps=steps)
    trainer = Trainer(cfg)
    t0 = time.perf_counter()
    losses = trainer.fit(o, d, c, log_every=1, log_fn=lambda s: None)
    log(f"  Trainer.fit {g}^3, {ts.views} views, "
        f"{ts.rays} rays/step: losses {losses} "
        f"({time.perf_counter() - t0:.1f} s with compile)")
    assert np.isfinite(losses).all(), "non-finite loss"
    assert losses[-1] < losses[0], "loss did not fall"

    # steady steps/s of the trainer's step function
    idx = np.random.RandomState(1).randint(0, len(o), ts.rays)
    batch = [jnp.asarray(a[idx], jnp.float32) for a in (o, d, c)]
    params, opt_state = trainer.params, trainer.opt_state
    params, opt_state, loss = trainer.step_fn(params, opt_state, *batch)
    jax.block_until_ready(loss)
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        params, opt_state, loss = trainer.step_fn(params, opt_state, *batch)
    jax.block_until_ready((params, loss))
    sps = n / (time.perf_counter() - t0)
    log(f"  train steps/s: {sps:.3f} ({ts.rays} rays/step)")

    # one step's gradients: default device vs the CPU backend
    gg = sizes.grad_grid
    gsteps = 3 * gg
    vpu, o, d, c = training_problem(gg, 8, 32, gsteps, seed=2)
    idx = np.random.RandomState(2).randint(0, len(o), sizes.grad_rays)
    args = [np.asarray(a[idx], np.float32) for a in (o, d, c)]
    rng = np.random.RandomState(4)
    params = {"sigma": rng.uniform(0, 4, (gg,) * 3).astype(np.float32),
              "albedo": rng.uniform(0, 1, (gg,) * 3 + (3,)).astype(np.float32)}
    fn = _grad_fn(vpu, gsteps)
    dev = jax.devices()[0]
    cpu = jax.devices("cpu")[0]
    out = {}
    for name, device in (("default", dev), ("cpu", cpu)):
        put = jax.device_put((params, *args), device)
        loss, grads = fn(*put)
        out[name] = (float(loss), jax.tree.map(np.asarray, grads))
    for k in ("sigma", "albedo"):
        err = rel_l2(out["default"][1][k], out["cpu"][1][k])
        log(f"  grad {k} {gg}^3 {sizes.grad_rays} rays, {dev.platform} vs "
            f"cpu: rel L2 {err:.2e}")
        assert err <= GRAD_RTOL, f"grad {k}: rel L2 {err:.2e}"
    assert abs(out["default"][0] - out["cpu"][0]) <= 1e-5 * abs(out["cpu"][0])
    return sps


# ------------------------------------------------------------- 4 devices --

def phase_devices(sizes: Sizes, n_dev: int):
    """Ray-sharded (plain and overlapped) and z-slab grid-sharded train
    steps on an n-card mesh vs the same step on one card.  SGD keeps the
    update linear in the gradient, so the update compares gradients."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from voxel_tracer_tpu.parallel.grid_shard import make_ray_grid_mesh
    from voxel_tracer_tpu.parallel.grid_train import (
        make_grid_sharded_train_step, place_grid_params)
    from voxel_tracer_tpu.parallel.mesh import RAYS, make_ray_mesh
    from voxel_tracer_tpu.parallel.sharding import make_train_step
    from voxel_tracer_tpu.utils.profiling import training_problem

    devs = jax.devices()
    assert len(devs) >= n_dev, f"{len(devs)} devices, need {n_dev}"
    ts = sizes.train
    g = ts.grid
    steps = 3 * g
    vpu, o, d, c = training_problem(g, ts.views, ts.view_px, steps)
    idx = np.random.RandomState(1).randint(0, len(o), ts.rays)
    batch = [np.asarray(a[idx], np.float32) for a in (o, d, c)]
    rng = np.random.RandomState(5)
    params = {"sigma": rng.uniform(0, 4, (g,) * 3).astype(np.float32),
              "albedo": rng.uniform(0, 1, (g,) * 3 + (3,)).astype(np.float32)}
    opt = optax.sgd(0.5)

    def run(step, mesh, p):
        ray_sh = NamedSharding(mesh, P(RAYS))
        b = [jax.device_put(a, ray_sh) for a in batch]
        new_p, _, loss = step(p, opt.init(p), *b)
        jax.block_until_ready(new_p)
        t0 = time.perf_counter()
        for _ in range(3):
            out = step(p, opt.init(p), *b)
        jax.block_until_ready(out)
        return new_p, float(loss), (time.perf_counter() - t0) / 3

    # one-card references: the plain step, and the same 4-z-slab
    # decomposition the overlapped and grid-sharded steps compute
    mesh1 = make_ray_mesh(1)
    rep1 = jax.device_put(params, NamedSharding(mesh1, P()))
    refs = {}
    for slabs in (1, 4):
        p1, l1, dt1 = run(make_train_step(mesh1, opt, vpu, steps,
                                          overlap_slabs=slabs), mesh1, rep1)
        refs[slabs] = ({k: np.asarray(p1[k]) - params[k] for k in params}, l1)
        log(f"  1 card, {slabs} z-slab(s): loss {l1:.6f}, "
            f"step {dt1 * 1e3:.1f} ms")

    mesh = make_ray_mesh(n_dev)
    rep = NamedSharding(mesh, P())
    gmesh = make_ray_grid_mesh(1, n_dev)
    variants = [
        ("rays", 1, make_train_step(mesh, opt, vpu, steps), mesh,
         jax.device_put(params, rep)),
        ("rays+overlap_slabs=4", 4,
         make_train_step(mesh, opt, vpu, steps, overlap_slabs=4), mesh,
         jax.device_put(params, rep)),
        (f"grid z-slabs x{n_dev}", n_dev,
         make_grid_sharded_train_step(gmesh, opt, vpu, steps), gmesh,
         place_grid_params(gmesh, params)),
    ]
    for name, slabs, step, m, p in variants:
        new_p, loss, dt = run(step, m, p)
        for leaf in jax.tree.leaves(new_p):
            assert leaf.sharding.device_set == set(m.devices.flat), \
                f"{name}: an output is not on the mesh's devices"
        ref_delta, ref_loss = refs[slabs]
        delta = {k: np.asarray(new_p[k]) - params[k] for k in params}
        errs = {k: rel_l2(delta[k], ref_delta[k]) for k in params}
        log(f"  {n_dev} cards, {name}: loss {loss:.6f} (1 card "
            f"{ref_loss:.6f}), update rel L2 {errs}, step {dt * 1e3:.1f} ms")
        if slabs > 1:
            # not a pass/fail bound: how far the slab decomposition itself
            # is from the plain step
            plain = {k: rel_l2(delta[k], refs[1][0][k]) for k in params}
            log(f"    vs the plain one-card step: loss {refs[1][1]:.6f}, "
                f"update rel L2 {plain}")
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), name
        for k, e in errs.items():
            assert e <= GRAD_RTOL, f"{name}: {k} update rel L2 {e:.2e}"


# ------------------------------------------------------------------ main --

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="4: run only the four-card mesh phase")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU at tiny sizes (tests only)")
    args = ap.parse_args(argv)

    from voxel_tracer_tpu.utils import compile_cache

    compile_cache.enable()
    import jax

    sizes = TINY if args.cpu else Sizes()
    kernel_impl = "interpret" if args.cpu else "triton"
    dev = phase_device(args.cpu)
    t_start = time.perf_counter()
    if args.devices > 1:
        log(f"phase devices x{args.devices}")
        phase_devices(sizes, args.devices)
    else:
        for name, phase in (
                ("traversal", lambda: phase_traversal(sizes, kernel_impl)),
                ("frames", lambda: phase_frames(sizes, kernel_impl)),
                ("training", lambda: phase_training(sizes))):
            log(f"phase {name}")
            t0 = time.perf_counter()
            phase()
            log(f"phase {name} done in {time.perf_counter() - t0:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    if args.cpu:
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

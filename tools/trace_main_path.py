#!/usr/bin/env python3
"""Profile the main path on the GPU and reduce each trace to a table.

Traces, each in its own window after warm-up:
  train      3 `Trainer` steps, 128^3 grid, 131,072 rays/step
  lambert    1 lambert frame of the 64^3 noise volume at 1920x1088
             (kernel and XLA wavefront)
  full       1 full-material frame of the default scene at 1280x768
             (kernel and XLA wavefront)

For each window it prints the device busy share (union of GPU op intervals
over the window) and the GPU ops with the most device time, grouped by
name.  Traces are written under chiprun_out/traces/.

    python tools/trace_main_path.py [train,lambert,full]
"""

from __future__ import annotations

import dataclasses
import glob
import os
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def reduce_trace(logdir, top=12):
    """Busy share of the window and the top GPU ops by device time."""
    import jax

    path = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                         "*.xplane.pb")))[-1]
    pd = jax.profiler.ProfileData.from_file(path)
    intervals, by_name = [], defaultdict(lambda: [0.0, 0])
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        print(f"   plane {plane.name}: lines "
              f"{sorted({line.name for line in plane.lines})}", flush=True)
        for line in plane.lines:
            # one line per stream; "XLA Ops"/"XLA Modules" lines repeat the
            # kernels at a coarser grain, so count stream lines only
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                s = ev.start_ns
                intervals.append((s, s + ev.duration_ns))
                rec = by_name[ev.name]
                rec[0] += ev.duration_ns
                rec[1] += 1
    if not intervals:
        return 0.0, 0.0, []
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    tops = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return busy / 1e6, window / 1e6, tops


def traced(name, fn, n=1):
    import jax

    jax.block_until_ready(fn())              # warm-up / compile
    logdir = os.path.join(ROOT, "chiprun_out", "traces", name)
    jax.profiler.start_trace(logdir)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) * 1e3
    jax.profiler.stop_trace()
    busy, window, tops = reduce_trace(logdir)
    print(f"== {name}: wall {wall:.3f} ms for {n}, device window "
          f"{window:.3f} ms, busy {busy:.3f} ms "
          f"({busy / max(wall, 1e-9):.3f} of wall)", flush=True)
    for op, (ns, cnt) in tops:
        print(f"   {ns / 1e6:10.3f} ms  x{cnt:<6d} {op[:100]}", flush=True)


def main(argv):
    from voxel_tracer_tpu.utils import compile_cache

    compile_cache.enable()
    import jax.numpy as jnp
    from voxel_tracer_tpu.renderer import Renderer
    from voxel_tracer_tpu.trainer import TrainConfig, Trainer
    from voxel_tracer_tpu.utils import profiling

    which = (argv[0] if argv else "train,lambert,full").split(",")
    from voxel_tracer_tpu.utils.device import card_line

    print(f"card: {card_line()}", flush=True)
    if "train" in which:
        ts = profiling.TrainShape()
        g = ts.grid
        vpu, o, d, c = profiling.training_problem(g, ts.views, ts.view_px,
                                                  3 * g)
        tr = Trainer(TrainConfig(grid_size=(g, g, g), vpu=vpu,
                                 rays_per_batch=ts.rays, march_steps=3 * g))
        idx = np.random.RandomState(1).randint(0, len(o), ts.rays)
        batch = [jnp.asarray(a[idx], jnp.float32) for a in (o, d, c)]
        state = [tr.params, tr.opt_state]

        def step():
            state[0], state[1], loss = tr.step_fn(state[0], state[1], *batch)
            return loss

        traced("train_3_steps", step, n=3)
    scenes = {name: rest for name, *rest in profiling.frame_scenes()}
    for key, name in (("lambert", "lambert_noise64"),
                      ("full", "full_default_scene")):
        if key not in which:
            continue
        config, sd, cam = scenes[name]
        for impl in ("triton", "xla"):
            r = Renderer(dataclasses.replace(config, traversal=impl))
            traced(f"{name}_{impl}", lambda: r.render(sd, cam, frame=0))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

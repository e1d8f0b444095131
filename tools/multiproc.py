"""Launcher: N-process jax.distributed run on localhost (CPU-only
processes) -> chiprun_out/MULTIPROC.json (not committed).

Spawns N worker processes (tools/multiproc_worker.py), each with
--xla_force_host_platform_device_count virtual CPU devices, sharing one
global mesh; records the losses, topology, and wall time per step.  The
single-process run with the same GLOBAL device count is recorded next to
it for the equality check (same global compute, different process
topology).

    python tools/multiproc.py [--processes 2] [--devices 4] [--steps 3]
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_ROOT, "tools", "multiproc_worker.py")


def _env(devices):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env.pop("JAX_PLATFORMS", None)
    env["JAX_COMPILATION_CACHE_DIR"] = os.path.join(_ROOT, ".jax_cache")
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "1"
    return env


def run_multi(n_proc, devices, steps, mode="replicated"):
    s = socket.socket(); s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"; s.close()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, "--coordinator", coord,
         "--num-processes", str(n_proc), "--process-id", str(i),
         "--steps", str(steps), "--mode", mode],
        env=_env(devices), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=_ROOT) for i in range(n_proc)]
    outs = [p.communicate() for p in procs]
    wall = time.perf_counter() - t0
    for p, (so, se) in zip(procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"worker failed:\n{se[-2000:]}")
    res = json.loads(outs[0][0].strip().splitlines()[-1])
    res["wall_s"] = round(wall, 2)
    return res


def run_single(devices, steps, mode="replicated"):
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, _WORKER, "--steps", str(steps), "--mode", mode],
        env=_env(devices), capture_output=True, text=True, cwd=_ROOT)
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-2000:])
    res = json.loads(out.stdout.strip().splitlines()[-1])
    res["wall_s"] = round(time.perf_counter() - t0, 2)
    return res


def compare(n_proc, devices, steps, mode):
    multi = run_multi(n_proc, devices, steps, mode)
    single = run_single(n_proc * devices, steps, mode)
    match = max(abs(a - b) for a, b in zip(multi["losses"],
                                           single["losses"]))
    eff = (multi["steps_per_s"] / single["steps_per_s"]
           if single.get("steps_per_s") else None)
    return {
        "multi": multi, "single_process": single,
        "max_loss_diff": match,
        "steps_per_s_efficiency_vs_single": (round(eff, 3)
                                             if eff is not None else None),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--devices", type=int, default=4,
                    help="virtual devices per process")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()

    result = {
        "note": "N-process jax.distributed localhost runs vs the "
                "single-process run on the same global device count; "
                "losses must match up to reduction order.  'replicated' "
                "= pure ray-DP; 'grid' = DP x MP with z-slabs of the "
                "grid owned by DIFFERENT processes "
                "(parallel/grid_train.py).  steps_per_s is steady-state "
                "(first/compile step excluded); on this 2-core host the "
                "2-process run shares cores, so efficiency ~1.0 means "
                "the process boundary itself costs nothing",
        "replicated": compare(args.processes, args.devices, args.steps,
                              "replicated"),
        "grid": compare(args.processes, args.devices, args.steps, "grid"),
    }
    print(json.dumps(result, indent=1))
    os.makedirs(os.path.join(_ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(_ROOT, "chiprun_out", "MULTIPROC.json"), "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()

"""Timing utilities (template/precomp.h:162-173 Timer + dev/gui.cpp EMA FPS
analog), plus a device timer for benchmarks."""

from __future__ import annotations

import time


class Timer:
    """Elapsed-seconds timer (Timer analog)."""

    def __init__(self):
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def reset(self) -> float:
        now = time.perf_counter()
        dt, self.start = now - self.start, now
        return dt


class EmaFps:
    """Exponential-moving-average frame-rate tracker (dev/gui.cpp:35-48)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.frame_time = None

    def update(self, dt: float) -> float:
        if self.frame_time is None:
            self.frame_time = dt
        else:
            self.frame_time = (1 - self.alpha) * self.frame_time + self.alpha * dt
        return self.fps

    @property
    def fps(self) -> float:
        return 1.0 / self.frame_time if self.frame_time else 0.0


def device_time(fn, *args, warmup: int = 2, iters: int = 10):
    """Mean seconds per call of a jitted function over a steady window:
    ``warmup`` calls first, then ``iters`` calls ending in
    `jax.block_until_ready` (JAX returns before the device finishes)."""
    import jax

    out = None
    for _ in range(warmup):
        out = jax.block_until_ready(fn(*args))
    t = Timer()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return t.elapsed() / iters, out

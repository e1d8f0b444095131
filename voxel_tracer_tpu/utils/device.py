"""The device a measurement ran on, for every printed result."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """The GPUs' name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu():
    """JAX's first device, or SystemExit if it is not a GPU: a measurement
    never falls back to the CPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {dev.platform}")
    return dev


def device_record() -> dict:
    """Platform, device kind, device count and power limit for a result."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "power_limit": card_line().splitlines()[0].split(",")[-1].strip()}

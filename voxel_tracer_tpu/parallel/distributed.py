"""Multi-host bootstrap — `jax.distributed` wrapper.

The reference is single-process (SURVEY.md §2.4: no NCCL/MPI/sockets); this
framework initializes multi-host process groups and then runs all
collectives (NCCL on GPUs) via the mesh.  On a single host this is a no-op.
"""

from __future__ import annotations

import os

import jax


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None):
    """Initialize multi-host JAX if the environment asks for it.

    Priority: explicit args > JAX_COORDINATOR_ADDRESS env > cluster
    auto-detect (args all None) > single-process no-op.
    """
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator is None and num_processes is None:
        return False  # single process
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def process_info():
    return dict(
        process_index=jax.process_index(),
        process_count=jax.process_count(),
        local_devices=len(jax.local_devices()),
        global_devices=len(jax.devices()),
    )

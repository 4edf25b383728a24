"""Multi-host initialization.

The reference's world is a static MPI communicator created by
PetscInitialize (flucainit.c:14-18); the JAX equivalent is
``jax.distributed.initialize`` — one process per host (or per GPU),
collectives over NVLink within a host and the network across
hosts. Call before any jax computation on multi-host
deployments; single-host/single-process runs need nothing.
"""

from __future__ import annotations

import os

import jax

_initialized = False


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Idempotent jax.distributed.initialize wrapper; arguments
    default to the standard cluster environment variables."""
    global _initialized
    if _initialized:
        return
    if (
        coordinator_address is None
        and "JAX_COORDINATOR_ADDRESS" not in os.environ
        and "COORDINATOR_ADDRESS" not in os.environ
    ):
        # single-process run: nothing to do
        _initialized = True
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True


def process_info():
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }

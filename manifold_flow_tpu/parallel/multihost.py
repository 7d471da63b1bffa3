"""Multi-host initialization and cross-host utilities (SURVEY.md §5.8).

The reference's only cross-node mechanism is manual Slurm job sharding by
subject/run/trial over a shared filesystem (argv drivers, S2:65, S3:16-18).
Here the equivalent is a real SPMD runtime: `initialize()` wires up
jax.distributed from standard cluster environment variables (Slurm/OpenMPI
auto-detection is built into JAX), after which `jax.devices()` spans every
host and the ('frames', 'mesh') device mesh in parallel.partition scales
across hosts — frame shards ride the network between hosts, mesh-axis
collectives the links between a host's devices.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None) -> None:
    """Initialize jax.distributed (no-op if already initialized).

    With no arguments, JAX auto-detects Slurm / Open MPI environments;
    elsewhere pass `coordinator_address` ('host:port'), `num_processes` and
    `process_id` explicitly. Call before any other JAX API on every host.

    Devices per process: one process per host drives all of that host's
    GPUs (the default, and what run_trial's device meshes assume). A
    launch that starts one process per GPU must pass `local_device_ids`
    (e.g. [local_rank]) so each process claims only its own card — JAX
    reserves most of a card's memory in every process that opens it.
    """
    import jax

    if jax.distributed.is_initialized():
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids)
        logger.info("jax.distributed: process %d / %d, %d local devices",
                    jax.process_index(), jax.process_count(),
                    jax.local_device_count())
    except RuntimeError as e:
        if "already initialized" in str(e).lower():
            return
        raise


def is_primary() -> bool:
    """True on the process that should write artifacts / logs."""
    import jax

    return jax.process_index() == 0


def sync_hosts(name: str = "barrier") -> None:
    """Cross-host barrier (cheap psum on a scalar)."""
    import jax
    import jax.numpy as jnp

    if jax.process_count() == 1:
        return
    x = jnp.ones((jax.local_device_count(),))
    jax.pmap(lambda v: jax.lax.psum(v, "i"), axis_name="i")(x).block_until_ready()

"""Multi-host entry points (the mpiexec/PETSc-COMM_WORLD analog).

The reference launches one MPI rank per process (`makefile:2-7`) and lets
PETSc partition; here the analog is `jax.distributed` + a global device
mesh. All framework code is single-program (shard_map) and already global:
the ONLY multi-host-specific step is initialization, after which
`ShardedEngine` over `jax.devices()` spans hosts — axis-0 DSS ppermutes
ride NVLink within a host and the network across hosts, as SURVEY §2.3
prescribes.

Usage (same script on every host):

    from pynama_tpu.parallel.multihost import initialize
    initialize("host0:1234", num_processes=2, process_id=rank)
    p = Problem(cfg, solver="cg"); p.setUp()
    sk = ShardedEngine(p, ndev=len(jax.devices()))
    ...

On GPU hosts nothing announces the cluster to JAX: every process passes
the same coordinator_address (host:port of process 0, any free port),
num_processes, and its own process_id. Called without them,
`jax.distributed.initialize` fails unless a cluster manager it knows
(e.g. SLURM) provides them.
"""
from __future__ import annotations

import logging

logger = logging.getLogger("pynama_tpu.multihost")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> dict:
    """Initialize jax.distributed (idempotent) and report the topology."""
    import jax
    try:
        kw = {}
        if coordinator_address is not None:
            kw.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
        jax.distributed.initialize(**kw)
    except RuntimeError as e:
        # already initialized (or single-process run) — both fine
        logger.debug("jax.distributed.initialize: %s", e)
    info = {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
    logger.info("multihost topology: %s", info)
    return info


def is_primary() -> bool:
    """True on the rank-0-analog process (logging/IO gating)."""
    import jax
    return jax.process_index() == 0

"""Multi-host initialization — the missing piece of the distributed backend
(SURVEY.md §2.4: jax.distributed for multi-host initialization, a Mesh with
('data','table') axes, all-to-all id exchange).

The reference is strictly single-machine (reference: src/hogwild.rs:24-104
is its only parallel-training mechanism); this module is net-new capability.
``jax.distributed.initialize`` wires the N processes of a multi-host run
into one JAX runtime: after it returns, ``jax.devices()`` spans ALL hosts
and the ('data','table') mesh + collectives (parallel/mesh.py,
parallel/sharded.py) work unchanged — XLA hands the collectives to NCCL,
over NVLink between the cards of one host and over the network between
hosts.

Usage (one process per host, same command everywhere):

    python -m fwumious_wabbit_tpu ... \
        --fwt_hosts 4 --fwt_host_id $RANK --fwt_coordinator host0:7755 \
        --fwt_table_axis 8 --fwt_exchange a2a

MUST be called before any JAX backend initialization (so the CLI calls it
first thing in main(), before touching jax.devices()).
"""

from __future__ import annotations

import logging

log = logging.getLogger(__name__)

_initialized = False


def initialize_multihost(coordinator: str | None, num_hosts: int | None,
                         host_id: int | None) -> bool:
    """Initialize jax.distributed for an ``num_hosts``-process run.

    Returns True if distributed mode is active. Arguments may all be None
    (single-host: no-op). Nothing detects a cluster here: a multi-host run
    gives the coordinator address, the process count and this process's
    index.
    """
    global _initialized
    if _initialized:
        return True
    if not coordinator and (num_hosts is None or num_hosts <= 1):
        return False

    import jax

    kwargs = {}
    if coordinator:
        kwargs["coordinator_address"] = coordinator
    if num_hosts is not None:
        kwargs["num_processes"] = int(num_hosts)
    if host_id is not None:
        kwargs["process_id"] = int(host_id)
    jax.distributed.initialize(**kwargs)
    _initialized = True
    log.info(
        "multi-host initialized: process %d/%d, %d global / %d local devices",
        jax.process_index(), jax.process_count(),
        jax.device_count(), jax.local_device_count(),
    )
    return True


def is_initialized() -> bool:
    return _initialized

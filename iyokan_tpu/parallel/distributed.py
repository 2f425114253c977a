"""Multi-host initialization.

The reference is strictly single-process (SURVEY.md section 2.8); scaling
beyond one host here follows the standard jax recipe: call
:func:`initialize` once per process, then build the global mesh -- the
gate-batch axis spans every device of the job, and wire exchange between
DAG levels rides the all-gathers XLA inserts at the replicated-state
scatters (NCCL over NVLink within a host, the network across hosts).
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """jax.distributed.initialize with env-var fallbacks
    (IYOKAN_COORDINATOR / IYOKAN_NUM_PROCESSES / IYOKAN_PROCESS_ID).

    Nothing detects a cluster on its own: give the coordinator address
    (e.g. localhost:<free port>), the process count and this process's id.
    """
    kwargs = {}
    addr = coordinator_address or os.environ.get("IYOKAN_COORDINATOR")
    if addr:
        kwargs["coordinator_address"] = addr
    npn = num_processes or os.environ.get("IYOKAN_NUM_PROCESSES")
    if npn:
        kwargs["num_processes"] = int(npn)
    pid = process_id if process_id is not None else os.environ.get(
        "IYOKAN_PROCESS_ID"
    )
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)


def global_mesh(axis: str = "gates"):
    """Mesh over every device in the (multi-host) job."""
    from .mesh import make_mesh

    return make_mesh(axis=axis)

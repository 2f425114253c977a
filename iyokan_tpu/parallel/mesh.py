"""Multi-chip sharding of the batched executors.

The reference has no distributed backend at all (SURVEY.md section 2.8): its
scaling axes were CPU worker threads and CUDA streams.  Here the natural
parallel axis is the *gate batch*: every expensive stage is already a batch
of independent rows (bootstrap rows per level, key-switch rows, RAM write
chains over 2^a addresses), so multi-chip execution is data parallelism over
that axis with the evaluation keys replicated:

  * mesh axis "gates": bootstrap/KS batches sharded along rows; XLA inserts
    the all-gather back to the replicated wire-state array at scatter time
    (wire exchange between DAG levels rides the device interconnect);
  * keys (bkntt, ksk, bk2ntt, pksk) replicated on every device.

The engines call :func:`shard_batch` on their big batches; with no mesh
configured the constraint is a no-op, so single-chip and sharded execution
share one code path.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

_active_mesh: Optional[Mesh] = None


def _min_rows_per_device() -> int:
    """Bucketing/mesh co-design knob: a level batch is sharded over the
    'gates' axis only when every device gets at least this many rows;
    smaller levels are replicated instead (running a 16-row bootstrap on
    8 devices would trade a full all-gather for no compute win -- a
    2-row-per-device GEMM leaves the matrix units idle either way)."""
    return int(os.environ.get("IYOKAN_SHARD_MIN_ROWS", "8"))


def make_mesh(n_devices: Optional[int] = None, axis: str = "gates") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _active_mesh
    _active_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _active_mesh


def shard_batch(x, axis: int = 0):
    """Constrain the batch axis to the 'gates' mesh axis.

    Levels too small to give every device `IYOKAN_SHARD_MIN_ROWS` rows are
    replicated instead (see :func:`_min_rows_per_device`); sharding also
    requires the axis length to divide evenly so no device computes a
    ragged shard.
    """
    mesh = _active_mesh
    if mesh is None:
        return x
    n = mesh.devices.size
    rows = x.shape[axis]
    if rows < n * _min_rows_per_device() or rows % n:
        return replicated(x)
    spec = [None] * x.ndim
    spec[axis] = "gates"
    return jax.lax.with_sharding_constraint(
        x, NamedSharding(mesh, P(*spec))
    )


def batch_sharding(shape, axis: int = 0) -> Optional[NamedSharding]:
    """The NamedSharding `shard_batch` would constrain `shape` to (None if
    no mesh is active).  Exposed so tests can assert placement."""
    mesh = _active_mesh
    if mesh is None:
        return None
    n = mesh.devices.size
    if shape[axis] < n * _min_rows_per_device() or shape[axis] % n:
        return NamedSharding(mesh, P())
    spec = [None] * len(shape)
    spec[axis] = "gates"
    return NamedSharding(mesh, P(*spec))


def replicated(x):
    mesh = _active_mesh
    if mesh is None:
        return x
    return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, P()))


def replicated_sharding() -> Optional[NamedSharding]:
    """The sharding of an array held whole on every device of the active
    mesh (None without a mesh)."""
    mesh = _active_mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, P())


def replicate_on_mesh(tree):
    """Place a pytree (host or device arrays) whole on every device of the
    active mesh.  The engine's state enters its first cycle this way, with
    the sharding its jitted calls give it back, so the second cycle reuses
    the first one's compiled programs.  No-op without a mesh."""
    rep = replicated_sharding()
    if rep is None:
        return tree
    return jax.device_put(tree, rep)

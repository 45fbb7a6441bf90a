"""Device-mesh construction for multi-chip scaling.

The reference has no distribution layer at all (single process,
std::thread only — SURVEY.md parallelism inventory). The rebuild scales
through a 2D logical mesh:

  * axis "batch": data parallelism over multistart ramps (thousands of
    independent optimizations — the production win);
  * axis "rows": sequence-parallel sharding of the Hessian's time-row batch
    (the reference's thread pool over Hessian rows,
    src/OptimalControl.cpp:305-335, mapped onto devices).

Shardings are plain `jax.sharding` annotations; XLA inserts all collectives
(psum for reductions, all-gathers for replication; NCCL on GPUs). For
multi-host runs call `init_distributed(...)` before `make_mesh()` — the
same code then spans hosts with no further changes.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "batch_sharding", "row_sharding", "P",
           "NamedSharding", "init_distributed"]


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Initialize multi-host JAX (jax.distributed) if not already done.

    Call once per process before make_mesh() on a multi-host run, with
    the coordinator address ("host:port"), the number of processes and
    this process's id. Safe no-op on a single host.
    """
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process environment
    return jax.process_count(), jax.process_index()


def _factor(n: int) -> tuple[int, int]:
    """Factor n into (batch, rows) with rows the smaller power-like factor."""
    rows = 1
    for r in (2, 4, 8):
        if n % r == 0 and n // r >= r:
            rows = r
    return n // rows, rows


def make_mesh(n_devices: int | None = None, rows: int | None = None,
              devices=None) -> Mesh:
    """Create a ("batch", "rows") mesh over the first n_devices devices."""
    if devices is None:
        devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    devices = devices[:n]
    if rows is None:
        nb, nr = _factor(n)
    else:
        nr = rows
        nb = n // nr
    arr = np.array(devices).reshape(nb, nr)
    return Mesh(arr, axis_names=("batch", "rows"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a leading batch axis over the whole mesh (pure DP)."""
    return NamedSharding(mesh, P(("batch", "rows")))


def row_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a leading time-row axis over the "rows" mesh axis only."""
    return NamedSharding(mesh, P("rows"))

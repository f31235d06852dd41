"""Multi-host execution support.

The reference is strictly single-GPU (SURVEY §2: no collectives, no process
groups).  Here the recipe is one JAX process per host and a global mesh whose
**model (TP) axis stays inside one host** — every card of a host reaches
every other over NVLink at the same rate — and whose data axis spans hosts,
so the per-token TP collectives (psum / reduce-scatter from
``parallel/tp.py``) never leave a host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Start the JAX distributed runtime (one call per host, before first use
    of jax.devices()); give all three arguments where no cluster manager
    supplies them."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def make_pod_mesh(
    tp: Optional[int] = None,
    axis_names: Sequence[str] = ("data", "model"),
) -> Mesh:
    """Global (data, model) mesh over every device of every process.

    ``tp`` defaults to the per-host device count — the largest TP degree whose
    collectives never leave a host.  Data parallelism takes the remaining
    factor.  Devices are ordered by (process, id), so each model-axis row
    lies inside one host whenever ``tp`` divides the local device count.
    """
    n_total = jax.device_count()
    tp = tp or jax.local_device_count()
    if n_total % tp:
        raise ValueError(f"tp={tp} must divide device count {n_total}")
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return Mesh(np.asarray(devs).reshape(n_total // tp, tp), tuple(axis_names))

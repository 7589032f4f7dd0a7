"""Device mesh construction.

The workload's only parallelism axis is the scenario batch (SURVEY.md
section 2 table): a 1-D ``data`` mesh row-partitions the batch across every
device. The cards of one host reach each other all to all (NVLink), so the
mesh follows the algorithm alone; the only collective is the stats psum.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh

DATA_AXIS = "data"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices (default: all)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis_name,))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (one call per host before any jax op).

    Thin wrapper over ``jax.distributed.initialize``. Pass the coordinator
    address (``host:port``), the process count and this process's id;
    without them JAX auto-detects a cluster only where a scheduler
    announces one.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)

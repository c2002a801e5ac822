"""Mesh construction and (optional) multi-host initialization."""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


DATA_AXIS = "data"


def local_device_count() -> int:
    return len(jax.devices())


def data_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over `n_devices` (default: all visible devices).

    Reads are embarrassingly parallel, so one axis is the whole story;
    every card reaches every other over NVLink at the same rate, so the
    device order needs no topology awareness."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def initialize_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Multi-host bring-up (jax.distributed).  No-op for single host.

    The reference's cross-node story is manual SLURM job splitting
    (col_0_test.sh:1-12, README.md:261-270); here every host calls this
    once and then participates in the same mesh."""
    if num_processes is None or num_processes <= 1:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )

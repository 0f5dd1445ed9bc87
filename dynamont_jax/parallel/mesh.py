"""Device mesh construction for data-parallel read processing.

Resquiggling is embarrassingly parallel over reads, so the canonical mesh is
one-dimensional: axis "reads" spans every card (across processes and hosts
via jax.distributed). Training adds psum collectives over the same axis to
pool Baum-Welch statistics (the device-side equivalent of the reference
pooling per-read estimates on the driver host, ref:
src/python/segmentation/train.py:236-247).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

READS_AXIS = "reads"


def make_mesh(n_devices: int | None = None, axis: str = READS_AXIS) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, required: bool = False,
                     local_device: int | None = None) -> None:
    """Multi-process bring-up.

    Cluster parameters come from arguments, the DYNAMONT_COORDINATOR /
    DYNAMONT_NUM_PROCESSES / DYNAMONT_PROCESS_ID environment variables, or
    jax.distributed auto-detection (SLURM), in that order. Several
    processes on one multi-card host run one process per card: give each
    its card index as `local_device` or DYNAMONT_LOCAL_DEVICE, so no
    process opens (and reserves memory on) another's card. With
    required=True (the CLIs' --distributed flag) a failed bring-up raises
    instead of silently degrading to a single-process run.
    """
    import os

    coordinator = coordinator or os.environ.get("DYNAMONT_COORDINATOR")
    if num_processes is None and os.environ.get("DYNAMONT_NUM_PROCESSES"):
        num_processes = int(os.environ["DYNAMONT_NUM_PROCESSES"])
    if process_id is None and os.environ.get("DYNAMONT_PROCESS_ID"):
        process_id = int(os.environ["DYNAMONT_PROCESS_ID"])
    if local_device is None and os.environ.get("DYNAMONT_LOCAL_DEVICE"):
        local_device = int(os.environ["DYNAMONT_LOCAL_DEVICE"])
    card = {} if local_device is None else {"local_device_ids": [local_device]}
    try:
        if coordinator is not None:
            jax.distributed.initialize(coordinator, num_processes, process_id,
                                       **card)
        else:
            jax.distributed.initialize()
    except Exception as e:
        if required:
            raise RuntimeError(
                "distributed run requested but jax.distributed bring-up "
                f"failed: {e}"
            ) from e
        # single-process / unsupported environment: proceed standalone

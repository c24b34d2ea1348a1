"""Multi-process initialization and the global device mesh.

The communication layer the reference never had (SURVEY.md 2.19): the
transport is XLA collectives (NCCL on GPUs), so "backend setup" reduces to
``jax.distributed.initialize`` plus a mesh over every process's devices.

Usage in each process:

    from mpc_tpu.parallel.distributed import initialize, pod_mesh
    initialize(coordinator_address="localhost:12345", num_processes=2,
               process_id=0)       # no-op on single-process runs
    mesh = pod_mesh(n_model=1)     # scenario axis spans all global devices

The GPUs of one host are joined all to all (NVLink), so within a host the
mesh follows the algorithm alone. Scenario data parallelism needs no
cross-device traffic during a solve, so sharding scenarios across hosts is
free; the model/SP axis (ppermute/all_gather per cost evaluation) is laid
out within a host first so its collectives stay on the host's links.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh

from mpc_tpu.parallel.mesh import MODEL_AXIS, SCENARIO_AXIS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize jax.distributed when running multi-process.

    Without a coordinator address or a process count above one (in the
    arguments or the JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES env),
    silently no-ops, so the same script runs single-process. A multi-process
    run on GPUs must pass all three: nothing discovers a cluster by
    itself.
    """
    multi = (coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
             or (num_processes or 0) > 1
             or int(os.environ.get("JAX_NUM_PROCESSES", "1")) > 1)
    if not multi:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def pod_mesh(n_model: int = 1) -> Mesh:
    """(scenario, model) mesh over ALL global devices.

    Device order groups each host's local devices contiguously; with the
    model axis as the fastest-varying (innermost) dimension, every model-axis
    collective stays within one host, and only the embarrassingly-parallel
    scenario axis spans hosts.
    """
    devices = jax.devices()
    n = len(devices)
    if n % n_model:
        raise ValueError(f"{n} devices not divisible by model axis {n_model}")
    arr = np.asarray(devices).reshape(n // n_model, n_model)
    return Mesh(arr, (SCENARIO_AXIS, MODEL_AXIS))


def local_batch_slice(global_batch: int) -> slice:
    """The slice of a global scenario batch this process should feed
    (jax.make_array_from_process_local_data-style hosting)."""
    p = jax.process_index()
    n = jax.process_count()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{n} processes")
    per = global_batch // n
    return slice(p * per, (p + 1) * per)

"""Device-mesh construction for scaling MPC over several devices.

The reference is a single-threaded CPU loop (SURVEY.md 2.19) — this layer is
new, designed batch-first. Axes:

- ``scenario``: data parallelism over (initial state, road, params) tuples —
  the dominant scaling axis for batched MPC (thousands of solves per step).
- ``model``: sequence-parallel axis over road-centerline points (distributed
  nearest-point search) and long-horizon cost chunks — the TP/SP analogue.

The GPUs of one host are joined all to all, so the mesh shape follows the
algorithm alone: any (scenario, model) or (scenario, horizon) factorization
of the device count has the same link bandwidth on every axis. Across hosts,
jax.distributed (parallel/distributed.py) joins the processes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SCENARIO_AXIS = "scenario"
MODEL_AXIS = "model"
HORIZON_AXIS = "horizon"


def make_mesh(n_scenario: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (scenario, model) mesh over the available devices.

    Defaults to all devices on the scenario axis (pure DP). ``n_model > 1``
    carves a sequence-parallel sub-axis for distributed road geometry.
    """
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_scenario is None:
        n_scenario = n_dev // n_model
    if n_scenario * n_model != n_dev:
        raise ValueError(
            f"mesh {n_scenario}x{n_model} != {n_dev} devices")
    arr = np.asarray(devices).reshape(n_scenario, n_model)
    return Mesh(arr, (SCENARIO_AXIS, MODEL_AXIS))


def make_horizon_mesh(n_scenario: Optional[int] = None, n_horizon: int = 1,
                      devices: Optional[Sequence] = None) -> Mesh:
    """Build a (scenario, horizon) mesh: data parallelism over scenarios and
    stage parallelism over the MPC horizon (blocked associative-scan Riccati,
    parallel/lqr_sharded.py — SURVEY.md §2.19's horizon axis)."""
    if devices is None:
        devices = jax.devices()
    n_dev = len(devices)
    if n_scenario is None:
        n_scenario = n_dev // n_horizon
    if n_scenario * n_horizon != n_dev:
        raise ValueError(
            f"mesh {n_scenario}x{n_horizon} != {n_dev} devices")
    arr = np.asarray(devices).reshape(n_scenario, n_horizon)
    return Mesh(arr, (SCENARIO_AXIS, HORIZON_AXIS))


def scenario_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-axis sharding for per-scenario batches."""
    return NamedSharding(mesh, P(SCENARIO_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def centerline_sharding(mesh: Mesh) -> NamedSharding:
    """Centerline points sharded over the model axis: (points, 2)."""
    return NamedSharding(mesh, P(MODEL_AXIS, None))

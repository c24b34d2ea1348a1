"""mpc_tpu — batched model-predictive control in JAX, run on GPUs.

A from-scratch JAX/XLA re-design of the capabilities of
``panagiotou23/model-predictive-control`` (CasADi + alpaqa, CPU): batched
vehicle/chain MPC with ALM + PANOC(+L-BFGS) and AL-iLQR trajectory
optimizers, whole closed loops compiled into one XLA program, scaled over
device meshes via shard_map. Its accelerator is an NVIDIA H100.

Layering (see SURVEY.md):
  models/    — parameter pytrees, bicycle & hanging-chain ODEs, RK4 discretizer
  ops/       — road geometry, Bezier paths, stage costs, potential fields
  solver/    — Problem container, PANOC/ALM, iLQR/Riccati, matmul precision
  control/   — MPC controllers (warm-started, event-triggered, simple)
  parallel/  — mesh construction, sharded batched solves
  decision/  — game-theoretic lane-change layer
  sim/       — closed-loop drivers and scenario suites
  viz/       — plotting / animation utilities
  utils/     — timing, metrics, checkpointing
"""

__version__ = "0.1.0"

from mpc_tpu.config import AlmConfig, MpcConfig, PanocConfig  # noqa: F401
from mpc_tpu.models.params import ChainParams, VehicleParams  # noqa: F401

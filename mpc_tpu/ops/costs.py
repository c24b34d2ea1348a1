"""Stage costs for the MPC optimal-control problems.

JAX-native equivalent of the reference's symbolic cost generators
(vehicle: car_dynamics.py:230-258; hanging chain: alpaqa_example.py:129-141).
Pure functions over (state, input, parameters) — traced once inside the OCP
objective, differentiated with ``jax.grad`` (replacing CasADi autodiff).
"""

from __future__ import annotations

import jax.numpy as jnp

from mpc_tpu.ops.road import compute_errors_ocp

# Default weights c = [v, cte, pos_err, heading_err, steer, drive]
# (reference: car_dynamics.py:230).
DEFAULT_VEHICLE_WEIGHTS = (0.5, 1.0, 1.0, 0.5, 0.1, 0.01)


def vehicle_stage_cost(x: jnp.ndarray, u: jnp.ndarray, centerline: jnp.ndarray,
                       target_v: float,
                       c=DEFAULT_VEHICLE_WEIGHTS,
                       errors_fn=compute_errors_ocp) -> jnp.ndarray:
    """Vehicle tracking stage cost (reference: car_dynamics.py:252-257):

      L = c0 (|v| - v_ref)^2 + c1 cte^2 + c2 pos_err^2 + c3 head_err^2
          + c4 delta^2 + c5 d^2

    ``errors_fn(pos, heading, centerline)`` defaults to the single-device
    road errors; pass the sequence-parallel variant
    (parallel.road_sp.make_sp_errors_fn) when the centerline is sharded.
    """
    pos = x[:2]
    err = errors_fn(pos, x[2], centerline)
    # Pacejka state [x, y, phi, vx, vy, omega] -> speed = |(vx, vy)|;
    # simplified kinematic state [x, y, phi, v] -> speed = |v|.
    if x.shape[0] >= 5:
        speed = jnp.sqrt(x[3] ** 2 + x[4] ** 2)
    else:
        speed = jnp.abs(x[3])
    return (c[0] * (speed - target_v) ** 2
            + c[1] * err.cte ** 2
            + c[2] * err.pos_error ** 2
            + c[3] * err.heading_error ** 2
            + c[4] * u[1] ** 2
            + c[5] * u[0] ** 2)


def vehicle_stage_residuals(x: jnp.ndarray, u: jnp.ndarray,
                            centerline: jnp.ndarray, target_v: float,
                            c=DEFAULT_VEHICLE_WEIGHTS,
                            errors_fn=compute_errors_ocp) -> jnp.ndarray:
    """Residual form of :func:`vehicle_stage_cost`:

        vehicle_stage_cost(x, u, ...) == sum(vehicle_stage_residuals(...)**2)

    (asserted in tests/test_ilqr.py). Gauss-Newton solvers use the residual
    Jacobian for PSD curvature without second-order AD through the
    centerline scan — the cost IS a weighted least-squares objective
    (reference: car_dynamics.py:252-257), so GN is exact up to residual
    curvature.
    """
    pos = x[:2]
    err = errors_fn(pos, x[2], centerline)
    if x.shape[0] >= 5:
        speed = jnp.sqrt(x[3] ** 2 + x[4] ** 2)
    else:
        speed = jnp.abs(x[3])
    w = [jnp.sqrt(jnp.asarray(ci, x.dtype)) for ci in c]
    return jnp.stack([
        w[0] * (speed - target_v),
        w[1] * err.cte,
        w[2] * err.pos_error,
        w[3] * err.heading_error,
        w[4] * u[1],
        w[5] * u[0],
    ])


def chain_stage_cost(y: jnp.ndarray, u: jnp.ndarray, n_balls: int, dim: int,
                     x_end: jnp.ndarray, alpha: float = 25.0, beta: float = 1.0,
                     gamma: float = 0.01) -> jnp.ndarray:
    """Hanging-chain stage cost (reference: alpaqa_example.py:129-141):

      L = alpha ||y3 - x_end||^2 + beta sum_i ||vel_i||^2 + gamma ||u||^2
    """
    nd = n_balls * dim
    y2 = y[nd: 2 * nd]
    y3 = y[2 * nd:]
    return (alpha * jnp.sum((y3 - x_end) ** 2)
            + beta * jnp.sum(y2 ** 2)
            + gamma * jnp.sum(u ** 2))

"""Simple baseline controllers.

JAX-native equivalents of the reference's non-alpaqa controllers
(controller.py:72-156):

- ``simple_mpc``: the scipy ``minimize`` single-shooting controller
  (controller.py:72-108) re-built as a jitted Adam descent on the same
  forward-Euler rollout cost — no SciPy, no finite differences (the
  reference burned an O(N*dim) numerical-gradient loop per step;
  ``jax.grad`` replaces it), and it vmaps over batches.
  The reference's cost has a latent bug (``np.array(x[0], x[1])`` passes
  x[1] as a dtype, controller.py:89) — we implement the intended
  position-error cost and document the divergence.
- ``simple_mpc_initial``: fixed-target variant (controller.py:111-135).
- ``straight_line_controller``: constant [1, 0] input with error
  diagnostics returned (not printed) (controller.py:138-156).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from mpc_tpu.ops.road import RoadErrors, compute_errors_diagnostic


class SimpleMpcResult(NamedTuple):
    u0: jnp.ndarray
    u_seq: jnp.ndarray
    cost: jnp.ndarray


def _euler_rollout_cost(model: Callable, x0, us, dt, cost_stage):
    def step(x, u):
        x2 = x + model(x, u, None) * dt
        return x2, cost_stage(x2, u)

    _, cs = jax.lax.scan(step, x0, us)
    return jnp.sum(cs)


@partial(jax.jit, static_argnums=(0, 3, 6, 7))
def simple_mpc(model: Callable, x0: jnp.ndarray, centerline: jnp.ndarray,
               n_horiz: int = 2, dt: float = 0.1, target_velocity: float = 1.0,
               iters: int = 200, lr: float = 0.05) -> SimpleMpcResult:
    """Single-shooting MPC via Adam on the forward-Euler rollout
    (cost weights 100*cte^2 + 10*heading^2 + 10*|v|-ish per
    controller.py:78-96; the velocity term tracks ``target_velocity``
    instead of penalizing all motion — the reference's ``+10*|v|`` rewards
    stopping, which contradicts its own target_velocity argument)."""

    def stage(x, u):
        err = compute_errors_diagnostic(x[:2], x[2], centerline)
        v = jnp.sqrt(x[3] ** 2 + x[4] ** 2) if x.shape[0] >= 5 else x[3]
        return (100.0 * err.cte ** 2 + 10.0 * err.heading_error ** 2
                + 10.0 * (v - target_velocity) ** 2)

    def cost(us):
        return _euler_rollout_cost(model, x0, us, dt, stage)

    grad = jax.grad(cost)
    us0 = jnp.zeros((n_horiz, 2), x0.dtype)

    def adam_step(carry, _):
        us, m, v, t = carry
        g = grad(us)
        t = t + 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        mh = m / (1 - 0.9 ** t)
        vh = v / (1 - 0.999 ** t)
        us = us - lr * mh / (jnp.sqrt(vh) + 1e-8)
        return (us, m, v, t), None

    (us, _, _, _), _ = jax.lax.scan(
        adam_step, (us0, jnp.zeros_like(us0), jnp.zeros_like(us0), 0),
        None, length=iters)
    return SimpleMpcResult(u0=us[0], u_seq=us, cost=cost(us))


@partial(jax.jit, static_argnums=(0, 3, 5, 6))
def simple_mpc_initial(model: Callable, x0: jnp.ndarray,
                       target_state: jnp.ndarray, n_horiz: int = 2,
                       dt: float = 0.1, iters: int = 200,
                       lr: float = 0.05) -> SimpleMpcResult:
    """Fixed-target quadratic tracking variant (controller.py:111-135)."""

    def stage(x, u):
        return jnp.sum((x - target_state) ** 2)

    def cost(us):
        return _euler_rollout_cost(model, x0, us, dt, stage)

    grad = jax.grad(cost)
    us0 = jnp.zeros((n_horiz, 2), x0.dtype)

    def adam_step(carry, _):
        us, m, v, t = carry
        g = grad(us)
        t = t + 1
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        us = us - lr * (m / (1 - 0.9 ** t)) / (
            jnp.sqrt(v / (1 - 0.999 ** t)) + 1e-8)
        return (us, m, v, t), None

    (us, _, _, _), _ = jax.lax.scan(
        adam_step, (us0, jnp.zeros_like(us0), jnp.zeros_like(us0), 0),
        None, length=iters)
    return SimpleMpcResult(u0=us[0], u_seq=us, cost=cost(us))


class StraightLineOut(NamedTuple):
    u: jnp.ndarray
    nearest_index: jnp.ndarray
    nearest_point: jnp.ndarray
    errors: RoadErrors


def straight_line_controller(current_state: jnp.ndarray,
                             centerline: jnp.ndarray) -> StraightLineOut:
    """Constant full-drive zero-steer input plus road-error diagnostics
    (controller.py:138-156 — prints replaced by returned values)."""
    from mpc_tpu.ops.road import find_nearest_point
    pos = current_state[:2]
    idx, pt = find_nearest_point(pos, centerline)
    errs = compute_errors_diagnostic(pos, current_state[2], centerline)
    return StraightLineOut(u=jnp.asarray([1.0, 0.0], current_state.dtype),
                           nearest_index=idx, nearest_point=pt, errors=errs)

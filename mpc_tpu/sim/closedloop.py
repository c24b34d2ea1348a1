"""Closed-loop simulation drivers.

JAX-native equivalent of the reference's closed-loop scripts
(vehicle: main.py:62-167; chain: alpaqa_example.py:267-282). The reference
runs a 400-step Python for-loop crossing the pybind11 boundary every step;
here the whole closed loop is one ``lax.scan`` — solver included — compiled
once and batched over scenarios with ``vmap``.

As in the reference, the plant model IS the prediction model
(main.py:145 advances the plant with the same ``f_d``) — a correct solver
therefore yields near-perfect tracking, which our tests assert numerically
instead of eyeballing matplotlib plots (the reference's only oracle).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from mpc_tpu.control.mpc import MpcCarry, MpcController


class ClosedLoopOut(NamedTuple):
    ys: jnp.ndarray          # (n_sim, state_dim) plant states after each step
    us: jnp.ndarray          # (n_sim, input_dim) applied inputs
    carry: MpcCarry          # final warm-start state (tot_it/failures inside)
    inner_iters: jnp.ndarray  # (n_sim,) per-step inner iterations
    converged: jnp.ndarray    # (n_sim,) per-step convergence flags


def run_closed_loop(controller: MpcController, f_d: Callable,
                    y0: jnp.ndarray, static_param: Any, n_sim: int,
                    plant_params) -> ClosedLoopOut:
    """Run ``n_sim`` MPC steps under ``lax.scan``.

    ``static_param`` is the per-scenario parameter pytree *without* ``y0``
    (e.g. ``{"p": params, "centerline": cl}``); the current plant state is
    inserted as ``y0`` each step, mirroring the in-place parameter write at
    controller.py:54.
    """
    carry0 = controller.init_carry(y0.dtype)

    def scan_step(scan_carry, _):
        y, mpc_carry = scan_carry
        param = dict(static_param, y0=y)
        out = controller.step(mpc_carry, param)
        y_next = f_d(y, out.u0, plant_params)   # plant step (main.py:145)
        return (y_next, out.carry), (y_next, out.u0,
                                     out.result.inner_iterations,
                                     out.result.converged)

    (_, carry), (ys, us, iters, conv) = jax.lax.scan(
        scan_step, (y0, carry0), None, length=n_sim)
    return ClosedLoopOut(ys=ys, us=us, carry=carry,
                         inner_iters=iters, converged=conv)


def run_closed_loop_jit(controller: MpcController, f_d: Callable, n_sim: int):
    """Return a jitted ``(y0, static_param, plant_params) -> ClosedLoopOut``."""
    @jax.jit
    def run(y0, static_param, plant_params):
        return run_closed_loop(controller, f_d, y0, static_param, n_sim,
                               plant_params)
    return run

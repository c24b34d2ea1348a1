"""Fixed-step integrators and horizon rollouts.

JAX-native replacement for CasADi's ``integrator("rk", ...)`` +
``Function.mapaccum`` pipeline (reference: car_dynamics.py:136-147,159-166,
alpaqa_example.py:69-80,102-114). CasADi's "rk" plugin with
``number_of_finite_elements=4`` and ``tf=Ts`` performs 4 classical RK4 steps
of size ``Ts/4`` — we reproduce those coefficients exactly so discrete
trajectories match the reference to floating-point tolerance.

The N-step rollout is a ``jax.lax.scan`` — the XLA analogue of ``mapaccum``:
traced once, compiled once, fused by XLA.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

DEFAULT_TS = 0.05          # control interval (reference: car_dynamics.py:93)
DEFAULT_SUBSTEPS = 4       # "number_of_finite_elements" (reference: car_dynamics.py:136)


def rk4_step(f: Callable, x: jnp.ndarray, u: jnp.ndarray, p, h: float) -> jnp.ndarray:
    """One classical RK4 step of size h with zero-order-hold input."""
    k1 = f(x, u, p)
    k2 = f(x + 0.5 * h * k1, u, p)
    k3 = f(x + 0.5 * h * k2, u, p)
    k4 = f(x + h * k3, u, p)
    return x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def discretize(f: Callable, ts: float = DEFAULT_TS,
               substeps: int = DEFAULT_SUBSTEPS) -> Callable:
    """Build ``f_d(x, u, p) -> x_next`` from a continuous ODE ``f(x, u, p)``.

    Matches CasADi ``rk`` (4 finite elements per interval,
    reference: car_dynamics.py:136-145).
    """
    h = ts / substeps

    def f_d(x, u, p):
        for _ in range(substeps):  # static unroll — XLA fuses the chain
            x = rk4_step(f, x, u, p, h)
        return x

    return f_d


def euler_step(f: Callable, x: jnp.ndarray, u: jnp.ndarray, p, h: float) -> jnp.ndarray:
    """Forward-Euler step (used by the reference's scipy MPC, controller.py:85)."""
    return x + h * f(x, u, p)


@partial(jax.jit, static_argnums=(0,))
def _rollout_jit(f_d, x0, us, p):
    def step(x, u):
        x_next = f_d(x, u, p)
        return x_next, x_next

    _, xs = jax.lax.scan(step, x0, us)
    return xs


def rollout(f_d: Callable, x0: jnp.ndarray, us: jnp.ndarray, p) -> jnp.ndarray:
    """N-step rollout: ``xs[k] = f_d(xs[k-1], us[k])``, ``xs[0] = f_d(x0, us[0])``.

    Returns the states *after* each input, shape ``(N, state_dim)`` — same
    convention as the reference's ``mapaccum`` output (car_dynamics.py:159-166):
    column n of ``mpc_sim`` is the state after applying input n.
    """
    return _rollout_jit(f_d, x0, us, p)


def rollout_scan(f_d: Callable, x0: jnp.ndarray, us: jnp.ndarray, p) -> jnp.ndarray:
    """Untraced-entry rollout for use inside larger jitted computations."""
    def step(x, u):
        x_next = f_d(x, u, p)
        return x_next, x_next

    _, xs = jax.lax.scan(step, x0, us)
    return xs

"""Event-triggered MPC (ETC-MPC).

The reference names this variant but its file is a non-functional sketch
(event_triggered.py:18-35 — the call at line 35 raises TypeError;
SURVEY.md 2.15), so the behavior is designed fresh here as standard
event-triggered MPC: re-solve the OCP only when the plant deviates from the
last predicted trajectory by more than a threshold (or when the stored input
sequence runs out); otherwise replay the stored open-loop input.

Batching: a per-lane ``lax.cond`` would degenerate to computing
both branches under vmap. Instead the trigger sets the lane's solver
tolerance to +inf: the PANOC/ALM ``while_loop`` sees such lanes converged at
iteration 0 and freezes them, so a batch where few lanes trigger costs only
the triggered lanes' iterations — compute saving at batch granularity, with
fixed shapes throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import MpcController
from mpc_tpu.solver.problem import Problem


class EtcCarry(NamedTuple):
    U: jnp.ndarray          # stored input sequence (n,)
    lam: jnp.ndarray        # multipliers (m,)
    xs_pred: jnp.ndarray    # predicted states from last solve (N, state_dim)
    k: jnp.ndarray          # steps since last solve
    tot_solves: jnp.ndarray
    tot_it: jnp.ndarray


class EtcStepOut(NamedTuple):
    carry: EtcCarry
    u0: jnp.ndarray
    triggered: jnp.ndarray
    prediction_error: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class EventTriggeredController:
    """Wraps an :class:`MpcController`'s problem/solver with a trigger rule.

    ``threshold``: re-solve when ||y - xs_pred[k]||_2 exceeds it. The stored
    sequence also expires after ``n_horiz`` applications.
    """
    base: MpcController
    f_d: Callable
    threshold: float
    eps: float               # solver tolerance when triggered

    @property
    def n_horiz(self) -> int:
        return self.base.n_horiz

    def init_carry(self, state_dim: int = 6, dtype=jnp.float32) -> EtcCarry:
        mc = self.base.init_carry(dtype)
        return EtcCarry(
            U=mc.U, lam=mc.lam,
            xs_pred=jnp.full((self.n_horiz, state_dim), jnp.inf, dtype),
            k=jnp.asarray(self.n_horiz, jnp.int32),  # force solve at step 0
            tot_solves=jnp.zeros((), jnp.int32),
            tot_it=jnp.zeros((), jnp.int32),
        )

    def step(self, carry: EtcCarry, param: Any) -> EtcStepOut:
        y = param["y0"]
        n_in = self.base.input_dim

        k = jnp.minimum(carry.k, self.n_horiz - 1)
        # xs_pred[j] is the predicted state after applying inputs 0..j, so
        # after k applied inputs the plant should sit at xs_pred[k-1].
        pred = carry.xs_pred[jnp.clip(carry.k - 1, 0, self.n_horiz - 1)]
        pred_err = jnp.linalg.norm(y - pred)
        expired = carry.k >= self.n_horiz
        # >= so that threshold=0 degenerates to standard every-step MPC even
        # when plant == model reproduces the prediction bit-exactly
        triggered = (pred_err >= self.threshold) | expired

        # Warm start: shift the stored sequence by k applied inputs.
        shift = k * n_in
        U_shifted = jnp.roll(carry.U, -shift)
        tol = jnp.where(triggered, jnp.asarray(self.eps, y.dtype),
                        jnp.asarray(jnp.inf, y.dtype))

        res = self.base.solve(param, U_shifted, carry.lam, tol)

        # Triggered lanes adopt the fresh solution; others keep the old one.
        U_new = jnp.where(triggered, res.u, carry.U)
        lam_new = jnp.where(triggered, res.lam, carry.lam)
        k_new = jnp.where(triggered, 0, k)

        u0 = jax.lax.dynamic_slice(U_new, (k_new * n_in,), (n_in,))

        # Refresh the predicted trajectory on re-solve.
        def predict(U):
            us = U.reshape(self.n_horiz, n_in)

            def stepf(x, u):
                xn = self.f_d(x, u, param["p"])
                return xn, xn
            _, xs = jax.lax.scan(stepf, y, us)
            return xs

        xs_pred = jnp.where(triggered, predict(U_new), carry.xs_pred)

        new_carry = EtcCarry(
            U=U_new, lam=lam_new, xs_pred=xs_pred,
            k=k_new + 1,
            tot_solves=carry.tot_solves + triggered.astype(jnp.int32),
            tot_it=carry.tot_it + res.inner_iterations,
        )
        return EtcStepOut(new_carry, u0, triggered, pred_err)

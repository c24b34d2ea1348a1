"""Optimal-control / NLP problem containers.

JAX-native replacement for alpaqa's compiled problem object
(reference: main.py:54 ``generate_and_compile_casadi_problem`` — runtime C
codegen + cc + dlopen). Here the problem is a pair of pure JAX callables
(cost ``f`` and constraints ``g``) plus box data; "compilation" is ``jax.jit``
tracing — same role (trace once, run many), no process boundary, and the
result vmaps over scenario batches for free.

Problem form (alpaqa's NLP class):

    minimize    f(u; p)
    subject to  u in C          (decision-variable box)
                g(u; p) in D    (general-constraint box)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


# Unroll factor of the horizon scans on a GPU (capped at the scan length);
# see default_unroll.
GPU_UNROLL = 4


def default_unroll(n_steps: int) -> int:
    """The horizon-scan unroll used when a builder is given ``unroll=None``.

    Unrolling trades compile time for step time. XLA:CPU keeps the scans
    loops: unrolled graphs there only bloat compile time. On a GPU the scan
    is unrolled by ``GPU_UNROLL``, capped at ``n_steps``. On an H100 (700 W)
    the headline closed-loop step (N=12, batch 1024) took 0.366, 0.223,
    0.185, 0.168 and 0.157 s at unroll 1, 2, 3, 4 and 6, and 0.098 s fully
    unrolled; the compile grows with the unroll, to 505 s fully unrolled
    (examples/exp_unroll.py). Unroll 4 keeps most of the gain at a compile
    time that fits a cold start of chip_smoke.py.
    """
    if jax.default_backend() == "cpu":
        return 1
    return max(1, min(n_steps, GPU_UNROLL))


class Box(NamedTuple):
    """Closed interval box; +-inf entries disable a side."""
    lower: jnp.ndarray
    upper: jnp.ndarray

    @staticmethod
    def unbounded(n: int, dtype=jnp.float32) -> "Box":
        inf = jnp.full((n,), jnp.inf, dtype=dtype)
        return Box(-inf, inf)

    @property
    def is_bounded(self) -> bool:
        """Static check: any finite bound? (Evaluated at trace/build time.)"""
        import numpy as np
        return bool(np.any(np.isfinite(np.asarray(self.lower)))
                    or np.any(np.isfinite(np.asarray(self.upper))))


def project(x: jnp.ndarray, box: Box) -> jnp.ndarray:
    """Euclidean projection onto a box = clip."""
    return jnp.clip(x, box.lower, box.upper)


def project_difference(x: jnp.ndarray, box: Box) -> jnp.ndarray:
    """x - Pi_box(x): signed distance components to the box."""
    return x - project(x, box)


@dataclasses.dataclass(frozen=True)
class Problem:
    """A box-constrained NLP with general constraints.

    ``cost(u, param) -> scalar`` and ``constraints(u, param) -> (m,)`` are
    pure JAX callables closed over static structure (model, horizon, weights);
    per-scenario data (initial state, road, physical params) flows through
    ``param`` so one trace serves every scenario in a batch.
    """
    cost: Callable[[jnp.ndarray, Any], jnp.ndarray]
    constraints: Optional[Callable[[jnp.ndarray, Any], jnp.ndarray]]
    C: Box                      # decision-variable box (n,)
    D: Box                      # general-constraint box (m,)
    n: int                      # number of decision variables
    m: int                      # number of general constraints
    # Static marker: cost consumes param["obstacles"] (K, 4) — suite drivers
    # use it to decide whether to thread ScenarioBatch.obstacles through.
    uses_obstacles: bool = False

    def cost_grad(self):
        """Value-and-gradient of the plain cost (CasADi-autodiff replacement)."""
        return jax.value_and_grad(self.cost)


def build_ocp_problem(f_d: Callable, stage_cost: Callable, n_horiz: int,
                      state_dim: int, input_dim: int, C: Box,
                      stage_constraints: Optional[Callable] = None,
                      n_stage_constraints: int = 0,
                      D: Optional[Box] = None,
                      param_prep: Optional[Callable] = None,
                      unroll: Optional[int] = None) -> Problem:
    """Assemble a single-shooting OCP as a :class:`Problem`.

    Mirrors the reference's OCP assembly (main.py:25-59,
    alpaqa_example.py:169-212): decision variable = flat input sequence,
    cost = sum of stage costs along an N-step rollout, constraints = stacked
    per-stage constraint vectors. The rollout is a ``lax.scan`` (XLA-fused)
    instead of a symbolic ``mapaccum`` unroll.

    ``param`` convention: a dict with keys ``y0`` (initial state), ``p``
    (model params pytree) and whatever extra keys ``stage_cost`` /
    ``stage_constraints`` consume (e.g. ``centerline``) — the structured
    analogue of the reference's flat ``[y_init; centerline; params]`` vector
    (main.py:27-30).

    The stage cost/constraints receive the state *after* applying each input
    (reference convention: main.py:36-40 applies ``L`` to ``mpc_sim[:, n]``).

    ``unroll`` is the rollout scan's unroll factor; ``None`` takes
    :func:`default_unroll`.
    """
    n = input_dim * n_horiz
    m = n_stage_constraints * n_horiz
    if unroll is None:
        unroll = default_unroll(n_horiz)

    def rollout_states(u_flat, param):
        us = u_flat.reshape(n_horiz, input_dim)

        def step(x, u):
            x_next = f_d(x, u, param["p"])
            return x_next, x_next

        _, xs = jax.lax.scan(step, param["y0"], us, unroll=unroll)
        return xs, us

    def _prep(param):
        # derive solve-constant auxiliaries from the parameters (e.g. the
        # nearest-point window anchor) once per cost/constraint evaluation
        return param_prep(param) if param_prep is not None else param

    def cost(u_flat, param):
        param = _prep(param)
        xs, us = rollout_states(u_flat, param)
        stage = jax.vmap(lambda x, u: stage_cost(x, u, param))(xs, us)
        return jnp.sum(stage)

    constraints = None
    if stage_constraints is not None:
        def constraints(u_flat, param):
            param = _prep(param)
            xs, us = rollout_states(u_flat, param)
            g = jax.vmap(lambda x, u: stage_constraints(x, u, param))(xs, us)
            return g.reshape(-1)

    if D is None:
        D = Box.unbounded(m)

    return Problem(cost=cost, constraints=constraints, C=C, D=D, n=n, m=m)

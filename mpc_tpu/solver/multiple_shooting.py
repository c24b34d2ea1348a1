"""Multiple-shooting OCP: horizon-parallel trajectory optimization.

The single-shooting OCP (solver/problem.py:build_ocp_problem) evaluates its
cost through an N-step sequential rollout — sequential depth N per cost/
gradient evaluation, the long-horizon bottleneck (BASELINE.json config #2,
N=40; SURVEY.md §5 'long-context' row). Multiple shooting is the data-parallel
counter: split the horizon into M segments with the intermediate segment
start states added to the decision vector,

    z = [U (N*input_dim) ; X_1..X_{M-1} (state_dim each)]

roll all M segments out *in parallel* (vmap over segments — sequential depth
N/M), and glue them with defect equality constraints

    x_end(segment k) - X_{k+1} = 0     (Box D = {0})

handled by the existing ALM layer. This is the control-theoretic analogue of
blockwise/sequence-parallel attention: the horizon axis becomes a batch axis
with a small coupling constraint instead of a serial chain.

Also the structure alpaqa's own hanging-chain docs recommend for hard
horizons — but the reference only ever uses single shooting
(main.py:34-40, alpaqa_example.py:181-187).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from mpc_tpu.solver.problem import Box, Problem, default_unroll


class MsLayout(NamedTuple):
    n_horiz: int
    n_segments: int
    seg_len: int
    state_dim: int
    input_dim: int

    @property
    def n_inputs(self) -> int:
        return self.n_horiz * self.input_dim

    @property
    def n_states(self) -> int:
        return (self.n_segments - 1) * self.state_dim

    @property
    def n(self) -> int:
        return self.n_inputs + self.n_states


def unpack_decision(z: jnp.ndarray, lo: MsLayout):
    """Split z into (us (N, in), x_starts (M-1, state))."""
    us = z[: lo.n_inputs].reshape(lo.n_horiz, lo.input_dim)
    xs = z[lo.n_inputs:].reshape(lo.n_segments - 1, lo.state_dim)
    return us, xs


def pack_decision(us: jnp.ndarray, x_starts: jnp.ndarray) -> jnp.ndarray:
    return jnp.concatenate([us.reshape(-1), x_starts.reshape(-1)])


def build_ms_ocp_problem(f_d: Callable, stage_cost: Callable, n_horiz: int,
                         n_segments: int, state_dim: int, input_dim: int,
                         C_inputs: Box,
                         stage_constraints: Optional[Callable] = None,
                         n_stage_constraints: int = 0,
                         D_stage: Optional[Box] = None,
                         param_prep: Optional[Callable] = None,
                         unroll: Optional[int] = None,
                         state_bound: Optional[jnp.ndarray] = None):
    """Assemble a multiple-shooting Problem.

    Same conventions as build_ocp_problem (stage cost/constraints applied to
    post-input states; param dict with 'y0' and 'p'); returns
    ``(Problem, MsLayout)``. The defect equalities are appended after the
    per-stage constraints in g / D.

    ``state_bound`` (state_dim,), when given, boxes the intermediate segment
    start states ``|X_k| <= state_bound`` inside C — an optional belt-and-
    braces guard keeping the iterates inside a known-good region of the
    dynamics (box projection is free in PANOC). It is NOT required for
    convergence: the solver's L-BFGS noise guards (solver/panoc.py
    ``lbfgs_push`` min_step + ``tr_mult`` trust region) are what prevent the
    iterate from being launched into Pacejka blow-up regions, and
    tests/test_multiple_shooting.py passes without any bound.
    """
    if n_horiz % n_segments:
        raise ValueError(f"horizon {n_horiz} not divisible by {n_segments}")
    lo = MsLayout(n_horiz, n_segments, n_horiz // n_segments, state_dim,
                  input_dim)
    if unroll is None:
        unroll = default_unroll(lo.seg_len)

    def _prep(param):
        return param_prep(param) if param_prep is not None else param

    def all_states(z, param):
        """(N, state_dim) states after each input + (M,) segment end states."""
        us, x_starts = unpack_decision(z, lo)
        starts = jnp.concatenate([param["y0"][None], x_starts], axis=0)
        us_seg = us.reshape(lo.n_segments, lo.seg_len, lo.input_dim)

        def seg_rollout(x0, useg):
            def step(x, u):
                xn = f_d(x, u, param["p"])
                return xn, xn
            xe, xs = jax.lax.scan(step, x0, useg, unroll=unroll)
            return xs, xe

        xs, x_ends = jax.vmap(seg_rollout)(starts, us_seg)   # parallel over M
        return xs.reshape(lo.n_horiz, lo.state_dim), us, x_ends

    def cost(z, param):
        param = _prep(param)
        xs, us, _ = all_states(z, param)
        stage = jax.vmap(lambda x, u: stage_cost(x, u, param))(xs, us)
        return jnp.sum(stage)

    n_defects = (n_segments - 1) * state_dim
    m_stage = n_stage_constraints * n_horiz

    def constraints(z, param):
        param = _prep(param)
        xs, us, x_ends = all_states(z, param)
        _, x_starts = unpack_decision(z, lo)
        defects = (x_ends[:-1] - x_starts).reshape(-1)
        if stage_constraints is not None:
            g = jax.vmap(lambda x, u: stage_constraints(x, u, param))(xs, us)
            return jnp.concatenate([g.reshape(-1), defects])
        return defects

    if state_bound is None:
        xb = jnp.full((lo.n_states,), jnp.inf, jnp.float32)
    else:
        state_bound = jnp.asarray(state_bound, jnp.float32)
        if state_bound.shape != (state_dim,):
            raise ValueError(
                f"state_bound shape {state_bound.shape} != ({state_dim},)")
        xb = jnp.tile(state_bound, lo.n_segments - 1)
    C = Box(
        lower=jnp.concatenate([C_inputs.lower, -xb]),
        upper=jnp.concatenate([C_inputs.upper, xb]),
    )
    zeros = jnp.zeros((n_defects,), jnp.float32)
    if stage_constraints is not None:
        if D_stage is None:
            D_stage = Box.unbounded(m_stage)
        D = Box(lower=jnp.concatenate([D_stage.lower, zeros]),
                upper=jnp.concatenate([D_stage.upper, zeros]))
        m = m_stage + n_defects
    else:
        D = Box(lower=zeros, upper=zeros)
        m = n_defects

    prob = Problem(cost=cost, constraints=constraints, C=C, D=D, n=lo.n, m=m)
    return prob, lo


def ms_warm_start(f_d, lo: MsLayout, y0: jnp.ndarray, us: jnp.ndarray,
                  p) -> jnp.ndarray:
    """Feasible initialization: roll the input sequence out once and place
    the true segment boundary states in the decision vector."""
    def step(x, u):
        xn = f_d(x, u, p)
        return xn, xn

    _, xs = jax.lax.scan(step, y0, us.reshape(lo.n_horiz, lo.input_dim))
    boundary_idx = jnp.arange(1, lo.n_segments) * lo.seg_len - 1
    return pack_decision(us.reshape(lo.n_horiz, lo.input_dim),
                         xs[boundary_idx])

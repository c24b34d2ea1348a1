"""Augmented-Lagrangian (ALM) outer loop — pure JAX, batched, jit/vmap-able.

Replaces alpaqa's C++ ``ALMSolver`` (reference: controller.py:39-48):
general constraints ``g(u) in D`` are handled by a shifted-penalty augmented
Lagrangian; the smooth subproblem is minimized over the box C by the PANOC
inner solver. Semantics preserved from the reference configuration:
``eps=1e-6`` (final stationarity), ``delta=1e-4`` (constraint satisfaction),
``Sigma_0=1e5`` (initial penalty) — controller.py:41-43.

Augmented Lagrangian for g(u) in D with multipliers lam and penalties Sigma:

    zeta  = g(u) + lam / Sigma
    zhat  = Pi_D(zeta)
    psi   = f(u) + 1/2 sum_i Sigma_i (zeta_i - zhat_i)^2
    lam+  = Sigma * (zeta - zhat)            (multiplier update)
    e     = g(u) - zhat                      (constraint violation)

When D is unbounded (the vehicle OCP: main.py:57 leaves D at +-inf) the AL
term vanishes identically; the builder detects this *statically* and emits a
single full-tolerance PANOC solve — no outer loop is traced at all.

Batch-first: the outer loop is a ``lax.while_loop`` with per-lane convergence
masks, so the whole (outer x inner) solver vmaps over scenario batches and
shards over a mesh; one divergent scenario cannot stall the rest.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.solver.panoc import make_panoc_solver, _tree_where
from mpc_tpu.solver.precision import pinned_precision
from mpc_tpu.solver.problem import Problem, project


class AlmTrace(NamedTuple):
    """Optional per-outer-iteration history (``AlmConfig.trace=True``).

    Fixed-size buffers of length ``alm_cfg.max_iter``; rows past
    ``outer_iterations`` keep NaN. Together with the inner
    :class:`~mpc_tpu.solver.panoc.PanocTrace` this replaces alpaqa's
    streaming progress callback (reference: controller.py:23-24,38) with
    batch-friendly buffers.
    """
    psi: jnp.ndarray         # (max_outer,) AL objective after each inner solve
    violation: jnp.ndarray   # (max_outer,) ||e||_inf
    eps_k: jnp.ndarray       # (max_outer,) inner tolerance used
    sigma_max: jnp.ndarray   # (max_outer,) max penalty
    inner_iters: jnp.ndarray  # (max_outer,) PANOC iterations spent


class AlmResult(NamedTuple):
    u: jnp.ndarray
    lam: jnp.ndarray
    psi: jnp.ndarray
    converged: jnp.ndarray
    outer_iterations: jnp.ndarray
    inner_iterations: jnp.ndarray     # total PANOC iterations across outer loop
    constraint_violation: jnp.ndarray  # final ||e||_inf
    inner_convergence_failures: jnp.ndarray
    sigma: jnp.ndarray                 # final penalties (m,) — warm-start carry
    gamma: jnp.ndarray                 # final PANOC step size — warm-start carry
    trace: Any = None                  # AlmTrace when alm_cfg.trace
    inner_trace: Any = None            # PanocTrace of the LAST inner solve


class _OuterState(NamedTuple):
    u: jnp.ndarray
    lam: jnp.ndarray
    sigma: jnp.ndarray
    gamma: jnp.ndarray
    eps_k: jnp.ndarray
    e_prev: jnp.ndarray
    psi: jnp.ndarray
    outer: jnp.ndarray
    inner_total: jnp.ndarray
    failures: jnp.ndarray
    converged: jnp.ndarray
    violation: jnp.ndarray
    trace: Any = None        # AlmTrace buffers when enabled
    inner_trace: Any = None  # last inner PanocTrace when enabled


def make_alm_solver(problem: Problem, alm_cfg: AlmConfig = AlmConfig(),
                    panoc_cfg: PanocConfig = PanocConfig()) -> Callable:
    """Build ``solve(param, u0, lam0) -> AlmResult`` — jit/vmap-able.

    ``param`` is the per-scenario parameter pytree consumed by
    ``problem.cost`` / ``problem.constraints`` (the structured analogue of
    alpaqa's flat ``problem.param`` vector, controller.py:54).
    """
    has_general = problem.constraints is not None and problem.m > 0 \
        and problem.D.is_bounded

    if not has_general:
        # Statically constraint-free (vehicle OCP path): single PANOC solve.
        def psi_vg(u, args):
            param = args
            return jax.value_and_grad(problem.cost)(u, param)

        panoc = make_panoc_solver(psi_vg, problem.C, panoc_cfg)

        def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
            # ``tol`` overrides the configured tolerance per call; +inf makes
            # the lane converge at iteration 0 (used by event-triggered MPC
            # to skip untriggered lanes inside a batch at zero cost).
            if tol is None:
                tol = alm_cfg.eps
            res = panoc(u0, jnp.asarray(tol, u0.dtype), param,
                        gamma_init=gamma0)
            sigma = sigma0 if sigma0 is not None else \
                jnp.zeros((problem.m,), u0.dtype)
            return AlmResult(
                u=res.u, lam=lam0, psi=res.psi, converged=res.converged,
                outer_iterations=jnp.ones((), jnp.int32),
                inner_iterations=res.iterations,
                constraint_violation=jnp.zeros((), u0.dtype),
                inner_convergence_failures=(~res.converged).astype(jnp.int32),
                sigma=sigma,
                gamma=res.gamma,
                inner_trace=res.trace,
            )

        return pinned_precision(solve)

    # ---- general-constraint path -----------------------------------------
    def psi_vg(u, args):
        param, lam, sigma = args

        def psi(u_):
            f = problem.cost(u_, param)
            g = problem.constraints(u_, param)
            zeta = g + lam / sigma
            zhat = project(zeta, problem.D)
            return f + 0.5 * jnp.sum(sigma * (zeta - zhat) ** 2)

        return jax.value_and_grad(psi)(u)

    panoc = make_panoc_solver(psi_vg, problem.C, panoc_cfg)

    def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
        dtype = u0.dtype
        if tol is None:
            tol = alm_cfg.eps
        skip = jnp.asarray(tol, dtype) > jnp.asarray(1e30, dtype)
        # Warm-started penalties (MPC steady state: the previous step's Sigma
        # already encodes which constraints bind) skip the eps homotopy and
        # start the inner solver at the final tolerance — a warm solve then
        # typically needs a single outer iteration. Cold solves keep the
        # eps_0 -> eps schedule (alpaqa's ALM behavior).
        #
        # Warmness is *traced, per lane*: ``sigma0 <= 0`` anywhere marks a
        # cold lane (MpcCarry.init_carry seeds sigma = 0), so the very first
        # solve of a rollout keeps the homotopy while steady-state solves
        # skip it — inside one vmapped batch. Carried penalties are capped
        # at sigma_0: within a solve sigma only grows, so an uncapped carry
        # ratchets to sigma_max over a rollout, makes the AL so stiff that
        # gamma hits the f32 floor, and the ProjGradNorm2 criterion
        # ||r||/gamma becomes unreachable (the round-1 regression).
        if sigma0 is None:
            warm = jnp.zeros((), bool)
            sigma_in = jnp.zeros((problem.m,), dtype)
        else:
            sigma_in = sigma0.astype(dtype)
            warm = jnp.all(sigma_in > 0)
        # sigma_0 may be a scalar or an (m,) array — per-constraint initial
        # penalties let one ALM mix constraint families of different scales
        # (multiple shooting: soft stage inequalities + defect equalities).
        sigma_cold = jnp.broadcast_to(
            jnp.asarray(alm_cfg.sigma_0, dtype), (problem.m,))
        sigma_init = jnp.where(warm,
                               jnp.minimum(jnp.maximum(sigma_in, 1e-12),
                                           sigma_cold),
                               sigma_cold)
        gamma_in = (gamma0.astype(dtype) if gamma0 is not None
                    else jnp.zeros((), dtype))
        tr0, itr0 = None, None
        if alm_cfg.trace:
            nanbuf = jnp.full((alm_cfg.max_iter,), jnp.nan, dtype)
            tr0 = AlmTrace(psi=nanbuf, violation=nanbuf, eps_k=nanbuf,
                           sigma_max=nanbuf, inner_iters=nanbuf)
        if panoc_cfg.trace:
            from mpc_tpu.solver.panoc import PanocTrace
            inanbuf = jnp.full((panoc_cfg.max_iter,), jnp.nan, dtype)
            itr0 = PanocTrace(psi=inanbuf, criterion=inanbuf, gamma=inanbuf)
        st0 = _OuterState(
            u=u0,
            lam=lam0.astype(dtype),
            sigma=sigma_init,
            gamma=jnp.where(warm, gamma_in, jnp.zeros((), dtype)),
            eps_k=jnp.where(warm, jnp.asarray(alm_cfg.eps, dtype),
                            jnp.asarray(alm_cfg.eps_0, dtype)),
            e_prev=jnp.full((problem.m,), jnp.inf, dtype),
            psi=jnp.zeros((), dtype),
            outer=jnp.zeros((), jnp.int32),
            inner_total=jnp.zeros((), jnp.int32),
            failures=jnp.zeros((), jnp.int32),
            converged=skip,  # skipped lanes exit before the first outer iter
            violation=jnp.full((), jnp.inf, dtype),
            trace=tr0,
            inner_trace=itr0,
        )

        def cond(st: _OuterState):
            return (~st.converged) & (st.outer < alm_cfg.max_iter)

        def body(st: _OuterState) -> _OuterState:
            res = panoc(st.u, st.eps_k, (param, st.lam, st.sigma),
                        gamma_init=st.gamma)

            g = problem.constraints(res.u, param)
            zeta = g + st.lam / st.sigma
            zhat = project(zeta, problem.D)
            e = g - zhat
            viol = jnp.max(jnp.abs(e))

            # Inexact-ALM multiplier update: lam is updated even when the
            # inner solve stopped at its iteration cap — classical inexact
            # augmented-Lagrangian convergence only needs the inner
            # tolerance schedule, not exact minimizers (alpaqa does the
            # same; gating updates on inner success was tried and makes the
            # chain workload thrash).
            lam_new = jnp.clip(st.sigma * (zeta - zhat),
                               -alm_cfg.lam_max, alm_cfg.lam_max)

            # Per-constraint penalty increase on insufficient progress —
            # only for constraints still violated beyond delta. Growing
            # sigma on an already-satisfied constraint (|e| ~ f32 noise but
            # > theta * |e_prev|) ratchets the penalty for nothing, and in
            # f32 a needlessly stiff AL collapses gamma until the
            # ||r||/gamma criterion is unreachable.
            need_more = (jnp.abs(e) > alm_cfg.delta) \
                & (jnp.abs(e) > alm_cfg.theta * jnp.abs(st.e_prev))
            sigma_new = jnp.where(
                need_more,
                jnp.minimum(st.sigma * alm_cfg.penalty_factor, alm_cfg.sigma_max),
                st.sigma)
            e_prev_new = jnp.abs(e)

            at_final_eps = st.eps_k <= alm_cfg.eps * (1.0 + 1e-6)
            done = res.converged & at_final_eps & (viol <= alm_cfg.delta)

            eps_next = jnp.maximum(jnp.asarray(alm_cfg.eps, dtype),
                                   st.eps_k * alm_cfg.rho_eps)

            # The PANOC step size is NOT carried across outer iterations:
            # each lam/sigma update changes the augmented Lagrangian's
            # curvature, and a fresh finite-difference Lipschitz estimate
            # costs one candidate-fan evaluation — one inner iteration.
            # (Carrying res.gamma here was round 1's regression.) The carry
            # that matters — across MPC steps — happens through AlmResult.
            gamma_next = jnp.zeros((), dtype)

            tr = st.trace
            if alm_cfg.trace:
                k = st.outer
                tr = AlmTrace(
                    psi=tr.psi.at[k].set(res.psi),
                    violation=tr.violation.at[k].set(viol),
                    eps_k=tr.eps_k.at[k].set(st.eps_k),
                    sigma_max=tr.sigma_max.at[k].set(jnp.max(st.sigma)),
                    inner_iters=tr.inner_iters.at[k].set(
                        res.iterations.astype(dtype)))

            st_new = _OuterState(
                u=res.u, lam=lam_new, sigma=sigma_new, gamma=gamma_next,
                eps_k=eps_next,
                e_prev=e_prev_new, psi=res.psi,
                outer=st.outer + 1,
                inner_total=st.inner_total + res.iterations,
                failures=st.failures + (~res.converged).astype(jnp.int32),
                converged=done,
                violation=viol,
                trace=tr,
                inner_trace=res.trace if panoc_cfg.trace else None,
            )
            return _tree_where(st.converged, st, st_new)

        st = jax.lax.while_loop(cond, body, st0)
        # Skipped lanes (tol=+inf) never solved: preserve the raw incoming
        # sigma so a cold (sigma=0) lane stays cold for its next real solve.
        sigma_out = jnp.where(skip, sigma_in, st.sigma)
        return AlmResult(
            u=st.u, lam=st.lam, psi=st.psi, converged=st.converged,
            outer_iterations=st.outer,
            inner_iterations=st.inner_total,
            constraint_violation=st.violation,
            inner_convergence_failures=st.failures,
            sigma=sigma_out,
            gamma=jnp.where(skip, gamma_in, st.gamma),
            trace=st.trace,
            inner_trace=st.inner_trace,
        )

    return pinned_precision(solve)

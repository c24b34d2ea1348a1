"""Batched AL-iLQR with a mesh-shardable Riccati backward pass.

``solver/ilqr.py``'s solver family is per-lane (callers ``vmap`` it); its
Riccati backward therefore runs per lane on one device, and the
horizon-sharded blocked scan (``parallel/lqr_sharded.py``) was unreachable
from any OCP — a library function no controller could call. This module
closes that gap: a *natively batched* AL-iLQR
whose linear-quadratic subproblem is solved for the whole batch in one
call, dispatching to

- ``jax.vmap`` of the single-device Riccati (sequential or associative
  scan) when ``mesh is None`` — bitwise the same math as vmapping
  ``solver/ilqr.py``; or
- the blocked associative-scan Riccati over a ``(scenario, horizon)``
  device mesh (``make_lqt_horizon_sharded``) when a mesh is given: the
  per-stage element construction and gains are embarrassingly parallel,
  and the only cross-device traffic is the tiny all_gather carry exchange
  of the blocked scans (SURVEY.md §2.19 horizon axis, §5
  long-context row).

Lane semantics mirror ``solver/ilqr.py`` exactly (same exits, same
regularization schedule, same per-lane masking a ``vmap`` of the per-lane
solver would produce): parity is gated by ``tests/test_ilqr_sharded.py``
on the config-2 vehicle OCP (Pacejka, N=40, bounded state constraints —
reference main.py:43-52) against the vmapped per-lane solver, and the
mesh-sharded backward against the single-device batched one.

The reference has no counterpart for any of this: its solver is the
external alpaqa C++ NLP solver fed a flat problem (controller.py:27-48),
single-threaded, one scenario at a time.

Traces (``IlqrConfig.trace``) are not supported in the batched family —
use the per-lane solver for introspection.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mpc_tpu.solver.ilqr import (IlqrConfig, IlqrResult, resolve_unroll,
                                 _assert_stage_uniform)
from mpc_tpu.solver.lqr import lqt_solve_parallel, lqt_solve_sequential
from mpc_tpu.solver.precision import pinned_precision
from mpc_tpu.solver.problem import Box
from mpc_tpu.parallel.lqr_sharded import make_lqt_horizon_sharded


def _lqt_batched(cfg: IlqrConfig, n_horiz: int, mesh: Optional[Mesh]):
    """Batched LQT solve ``(x0 (B,n), stage arrays (B,N,...), QN, qN, P)``."""
    if mesh is not None:
        return make_lqt_horizon_sharded(mesh)
    if cfg.parallel_backward:
        base = lqt_solve_parallel
    else:
        base = functools.partial(lqt_solve_sequential,
                                 unroll=resolve_unroll(cfg, n_horiz))
    return jax.vmap(
        lambda x0, A, B, c, Q, q, R, r, QN, qN, P: base(
            x0, A, B, c, Q, q, R, r, QN, qN, P=P),
        in_axes=(0, 0, 0, 0, 0, 0, 0, 0, None, None, 0))


def _bwhere(mask, a, b):
    """Per-lane select over arbitrary-rank pytrees (mask is (B,))."""
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(mask.reshape(mask.shape + (1,) * (x.ndim - 1)),
                               x, y), a, b)


class _State(NamedTuple):
    us: jnp.ndarray          # (B, N, m)
    xs: jnp.ndarray          # (B, N+1, n)
    cost: jnp.ndarray        # (B,)
    reg: jnp.ndarray         # (B,)
    iters: jnp.ndarray       # (B,) int32
    converged: jnp.ndarray   # (B,) bool
    grad_norm: jnp.ndarray   # (B,)


def make_ilqr_solver_batched(f_d: Callable, stage_cost: Callable,
                             n_horiz: int, state_dim: int, input_dim: int,
                             u_box: Optional[Box] = None,
                             cfg: IlqrConfig = IlqrConfig(),
                             stage_residuals: Optional[Callable] = None,
                             mesh: Optional[Mesh] = None) -> Callable:
    """Build ``solve(us0 (B, N*m), param, al_args=None, skip=None)``.

    Same contract as :func:`mpc_tpu.solver.ilqr.make_ilqr_solver` with a
    leading batch axis: ``param`` carries per-lane ``y0`` (B, n) with the
    rest (``p``, ``centerline``) shared across lanes; ``al_args`` is
    ``(lam (B, m_al), sigma (B, m_al), stage_al[, stage_al_res])``;
    ``skip`` is (B,) bool. Returns a batched :class:`IlqrResult`
    (``trace=None``).
    """
    unroll = resolve_unroll(cfg, n_horiz)
    lqt_b = _lqt_batched(cfg, n_horiz, mesh)

    if u_box is not None:
        _assert_stage_uniform(u_box.lower, n_horiz, input_dim, "u_box.lower")
        _assert_stage_uniform(u_box.upper, n_horiz, input_dim, "u_box.upper")

    def clamp(u):
        if u_box is None:
            return u
        return jnp.clip(u, u_box.lower[:input_dim], u_box.upper[:input_dim])

    def solve(us0: jnp.ndarray, param: Any, al_args=None,
              skip=None) -> IlqrResult:
        Bb = us0.shape[0]
        dtype = us0.dtype
        us0 = us0.reshape(Bb, n_horiz, input_dim)
        pax = {k: (0 if k == "y0" else None) for k in param}

        stage_al = stage_al_res = None
        lam = sigma = None
        if al_args is not None:
            lam, sigma, stage_al, *rest = al_args
            stage_al_res = rest[0] if rest else None
            lam = lam.reshape(Bb, n_horiz, -1)
            sigma = sigma.reshape(Bb, n_horiz, -1)
        use_gn = (cfg.gauss_newton and stage_residuals is not None
                  and (al_args is None or stage_al_res is not None))
        al_ax = None if al_args is None else 0

        # --- per-lane closures (vmapped at call sites), mirroring
        # solver/ilqr.py stage for stage --------------------------------
        def fr_k(x, u, k, param, lam_l, sigma_l):
            xn = f_d(x, u, param["p"])
            r = stage_residuals(xn, u, param)
            if stage_al_res is not None:
                r = jnp.concatenate(
                    [r, stage_al_res(xn, u, param, lam_l[k], sigma_l[k])])
            return xn, r

        if use_gn:
            def l_k(x, u, k, param, lam_l, sigma_l):
                return jnp.sum(fr_k(x, u, k, param, lam_l, sigma_l)[1] ** 2)
        elif al_args is None:
            def l_k(x, u, k, param, lam_l, sigma_l):
                return stage_cost(f_d(x, u, param["p"]), u, param)
        else:
            def l_k(x, u, k, param, lam_l, sigma_l):
                xn = f_d(x, u, param["p"])
                return stage_cost(xn, u, param) \
                    + stage_al(xn, u, param, lam_l[k], sigma_l[k])

        def rollout_lane(us, param, lam_l, sigma_l):
            def step(x, uk):
                u, k = uk
                xn = f_d(x, clamp(u), param["p"])
                return xn, (xn, l_k(x, clamp(u), k, param, lam_l, sigma_l))
            _, (xs_tail, ls) = jax.lax.scan(
                step, param["y0"], (us, jnp.arange(n_horiz)), unroll=unroll)
            xs = jnp.concatenate([param["y0"][None], xs_tail], axis=0)
            return xs, jnp.sum(ls)

        rollout = jax.vmap(rollout_lane, in_axes=(0, pax, al_ax, al_ax))

        def derivatives_lane(xs, us, param, lam_l, sigma_l):
            if use_gn:
                def one(x, u, k):
                    (A, B), (Jx, Ju) = jax.jacfwd(
                        lambda x_, u_: fr_k(x_, u_, k, param, lam_l, sigma_l),
                        argnums=(0, 1))(x, u)
                    r = fr_k(x, u, k, param, lam_l, sigma_l)[1]
                    return (A, B,
                            2.0 * Jx.T @ Jx, 2.0 * Jx.T @ r,
                            2.0 * Ju.T @ Ju, 2.0 * Ju.T @ r,
                            2.0 * Ju.T @ Jx)
            else:
                def one(x, u, k):
                    A = jax.jacfwd(lambda x_: f_d(x_, u, param["p"]))(x)
                    B = jax.jacfwd(lambda u_: f_d(x, u_, param["p"]))(u)
                    lx, lu = jax.grad(l_k, argnums=(0, 1))(
                        x, u, k, param, lam_l, sigma_l)
                    (lxx, lxu), (lux, luu) = jax.hessian(
                        l_k, argnums=(0, 1))(x, u, k, param, lam_l, sigma_l)
                    return A, B, lxx, lx, luu, lu, lux
            return jax.vmap(one)(xs[:-1], us, jnp.arange(n_horiz))

        derivatives = jax.vmap(derivatives_lane,
                               in_axes=(0, 0, pax, al_ax, al_ax))

        def backward(xs, us, reg):
            A, B, Q, q, R, r, P = derivatives(xs, us, param, lam, sigma)
            Rr = R + reg[:, None, None, None] \
                * jnp.eye(input_dim, dtype=dtype)
            c = jnp.zeros((Bb, n_horiz, state_dim), dtype)
            sol = lqt_b(jnp.zeros((Bb, state_dim), dtype), A, B, c, Q, q,
                        Rr, r, jnp.zeros((state_dim, state_dim), dtype),
                        jnp.zeros((state_dim,), dtype), P)
            gnorm = jnp.max(jnp.abs(sol.ko), axis=(1, 2))
            return sol.Ko, sol.ko, gnorm

        def forward_lane(xs, us, Ks, kos, alpha, param, lam_l, sigma_l):
            def step(x, inp):
                x_nom, u_nom, K, ko, k = inp
                u = clamp(u_nom - alpha * ko
                          - (K @ (x - x_nom)[..., None])[..., 0])
                xn = f_d(x, u, param["p"])
                return xn, (xn, u, l_k(x, u, k, param, lam_l, sigma_l))
            _, (xs_t, us_n, ls) = jax.lax.scan(
                step, param["y0"],
                (xs[:-1], us, Ks, kos, jnp.arange(n_horiz)), unroll=unroll)
            xs_n = jnp.concatenate([param["y0"][None], xs_t], axis=0)
            return xs_n, us_n, jnp.sum(ls)

        fwd_lanes = jax.vmap(forward_lane,
                             in_axes=(0, 0, 0, 0, None, pax, al_ax, al_ax))
        fwd_fan = jax.vmap(
            lambda a, xs, us, Ks, kos: fwd_lanes(xs, us, Ks, kos, a,
                                                 param, lam, sigma),
            in_axes=(0, None, None, None, None))

        # --- batched masked iteration (the loop a vmap of the per-lane
        # while_loop would run: body for all lanes, updates masked) ------
        xs0, cost0 = rollout(us0, param, lam, sigma)
        skip_ = (jnp.zeros((Bb,), bool) if skip is None
                 else jnp.asarray(skip, bool))
        us_init = _bwhere(skip_, us0, clamp(us0))
        st0 = _State(us=us_init, xs=xs0, cost=cost0,
                     reg=jnp.full((Bb,), cfg.reg_init, dtype),
                     iters=jnp.zeros((Bb,), jnp.int32),
                     converged=skip_,
                     grad_norm=jnp.full((Bb,), jnp.inf, dtype))

        alphas = jnp.asarray(cfg.alphas, dtype)

        def lane_active(st: _State):
            return (~st.converged) & (st.iters < cfg.max_iter) \
                & (st.reg < cfg.reg_max)

        def cond(st: _State):
            return jnp.any(lane_active(st))

        def body(st: _State) -> _State:
            active = lane_active(st)
            Ks, kffs, gnorm = backward(st.xs, st.us, st.reg)
            xs_f, us_f, costs = fwd_fan(alphas, st.xs, st.us, Ks, kffs)
            costs = jnp.where(jnp.isnan(costs), jnp.inf, costs)  # (n_a, B)
            best = jnp.argmin(costs, axis=0)                     # (B,)
            lane = jnp.arange(Bb)
            best_cost = costs[best, lane]
            improved = best_cost < st.cost - 1e-12

            dcost = st.cost - best_cost
            rel = jnp.abs(dcost) / (jnp.abs(st.cost) + 1e-12)
            stalled = (~improved) & (rel < cfg.tol_stall)
            reg_ok = st.reg <= cfg.reg_conv_max
            conv = ((improved & (rel < cfg.tol_dcost))
                    | (gnorm <= cfg.tol_grad) | stalled) & reg_ok

            st_acc = st._replace(
                us=us_f[best, lane], xs=xs_f[best, lane], cost=best_cost,
                reg=jnp.maximum(st.reg * cfg.reg_down, cfg.reg_min),
                converged=conv, grad_norm=gnorm)
            st_rej = st._replace(reg=st.reg * cfg.reg_up,
                                 converged=conv, grad_norm=gnorm)
            st_new = _bwhere(improved, st_acc, st_rej)
            st_new = st_new._replace(iters=st.iters + 1)
            return _bwhere(active, st_new, st)

        st = jax.lax.while_loop(cond, body, st0)
        return IlqrResult(us=st.us.reshape(Bb, -1), xs=st.xs, cost=st.cost,
                          converged=st.converged, iterations=st.iters,
                          grad_norm=st.grad_norm, trace=None)

    return pinned_precision(solve)


def make_al_ilqr_solver_batched(f_d: Callable, stage_cost: Callable,
                                n_horiz: int, state_dim: int, input_dim: int,
                                u_box: Box,
                                stage_constraints: Optional[Callable] = None,
                                n_stage_constraints: int = 0,
                                D: Optional[Box] = None,
                                alm_cfg=None,
                                ilqr_cfg: IlqrConfig = IlqrConfig(),
                                stage_residuals: Optional[Callable] = None,
                                mesh: Optional[Mesh] = None):
    """Batched AL-iLQR ``solve(param, u0 (B,N*m), lam0 (B,m), ...)``.

    The batched counterpart of
    :func:`mpc_tpu.solver.ilqr.make_al_ilqr_solver` (same ALM outer
    semantics — solver/alm.py's delta/theta/penalty_factor schedule, warm
    sigma, lane-skip sentinel) with the inner iLQR's Riccati backward
    solvable horizon-sharded over ``mesh``. Returns a batched ``AlmResult``
    so batched MPC stepping code can drive it like a vmapped per-lane
    solver.
    """
    from mpc_tpu.config import AlmConfig
    from mpc_tpu.solver.alm import AlmResult
    from mpc_tpu.solver.problem import project

    if alm_cfg is None:
        alm_cfg = AlmConfig()

    has_general = stage_constraints is not None and n_stage_constraints > 0 \
        and D is not None and D.is_bounded
    m = n_stage_constraints * n_horiz if has_general else 0

    if not has_general:
        inner = make_ilqr_solver_batched(
            f_d, stage_cost, n_horiz, state_dim, input_dim, u_box=u_box,
            cfg=ilqr_cfg, stage_residuals=stage_residuals, mesh=mesh)

        def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
            Bb = u0.shape[0]
            dtype = u0.dtype
            skip = None if tol is None else \
                jnp.asarray(tol, dtype) > jnp.asarray(1e30, dtype)
            res = inner(u0, param, skip=skip)
            sigma = sigma0 if sigma0 is not None \
                else jnp.zeros((Bb, 0), dtype)
            return AlmResult(
                u=res.us, lam=lam0, psi=res.cost, converged=res.converged,
                outer_iterations=(res.iterations > 0).astype(jnp.int32),
                inner_iterations=res.iterations,
                constraint_violation=jnp.zeros((Bb,), dtype),
                inner_convergence_failures=(~res.converged).astype(jnp.int32),
                sigma=sigma, gamma=jnp.zeros((Bb,), dtype),
                inner_trace=None)

        return pinned_precision(solve)

    _assert_stage_uniform(D.lower, n_horiz, n_stage_constraints, "D.lower")
    _assert_stage_uniform(D.upper, n_horiz, n_stage_constraints, "D.upper")
    D_lo = D.lower.reshape(n_horiz, n_stage_constraints)[0]
    D_hi = D.upper.reshape(n_horiz, n_stage_constraints)[0]

    def stage_al(xn, u, param, lam_k, sigma_k):
        g = stage_constraints(xn, u, param)
        zeta = g + lam_k / sigma_k
        zhat = jnp.clip(zeta, D_lo, D_hi)
        return 0.5 * jnp.sum(sigma_k * (zeta - zhat) ** 2)

    def stage_al_res(xn, u, param, lam_k, sigma_k):
        g = stage_constraints(xn, u, param)
        zeta = g + lam_k / sigma_k
        zhat = jnp.clip(zeta, D_lo, D_hi)
        return jnp.sqrt(0.5 * sigma_k) * (zeta - zhat)

    inner = make_ilqr_solver_batched(
        f_d, stage_cost, n_horiz, state_dim, input_dim, u_box=u_box,
        cfg=ilqr_cfg, stage_residuals=stage_residuals, mesh=mesh)

    def constraints_from_traj(xs, us_flat, param, pax):
        def one(xs_l, us_l, param_l):
            us = us_l.reshape(n_horiz, input_dim)
            gs = jax.vmap(lambda xn, u: stage_constraints(xn, u, param_l))(
                xs_l[1:], us)
            return gs.reshape(-1)
        return jax.vmap(one, in_axes=(0, 0, pax))(xs, us_flat, param)

    class _St(NamedTuple):
        u: jnp.ndarray           # (B, N*m_in)
        lam: jnp.ndarray         # (B, m)
        sigma: jnp.ndarray       # (B, m)
        e_prev: jnp.ndarray      # (B, m)
        psi: jnp.ndarray         # (B,)
        outer: jnp.ndarray       # (B,) int32
        inner_total: jnp.ndarray
        failures: jnp.ndarray
        converged: jnp.ndarray   # (B,) bool
        violation: jnp.ndarray   # (B,)

    def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
        Bb = u0.shape[0]
        dtype = u0.dtype
        pax = {k: (0 if k == "y0" else None) for k in param}
        skip = (jnp.zeros((Bb,), bool) if tol is None
                else jnp.asarray(tol, dtype) > jnp.asarray(1e30, dtype))
        sigma_cold = jnp.full((Bb, m), alm_cfg.sigma_0, dtype)
        if sigma0 is None:
            sigma_in = jnp.zeros((Bb, m), dtype)
            sigma_init = sigma_cold
        else:
            sigma_in = sigma0.astype(dtype)
            warm = jnp.all(sigma_in > 0, axis=1, keepdims=True)
            sigma_init = jnp.where(
                warm, jnp.minimum(jnp.maximum(sigma_in, 1e-12), sigma_cold),
                sigma_cold)

        st0 = _St(u=u0, lam=lam0.astype(dtype), sigma=sigma_init,
                  e_prev=jnp.full((Bb, m), jnp.inf, dtype),
                  psi=jnp.zeros((Bb,), dtype),
                  outer=jnp.zeros((Bb,), jnp.int32),
                  inner_total=jnp.zeros((Bb,), jnp.int32),
                  failures=jnp.zeros((Bb,), jnp.int32),
                  converged=skip,
                  violation=jnp.full((Bb,), jnp.inf, dtype))

        def lane_active(st):
            return (~st.converged) & (st.outer < alm_cfg.max_iter)

        def cond(st):
            return jnp.any(lane_active(st))

        def body(st):
            active = lane_active(st)
            res = inner(st.u, param,
                        al_args=(st.lam, st.sigma, stage_al, stage_al_res))
            g = constraints_from_traj(res.xs, res.us, param, pax)
            zeta = g + st.lam / st.sigma
            zhat = jax.vmap(lambda z: project(z, D))(zeta)
            e = g - zhat
            viol = jnp.max(jnp.abs(e), axis=1)
            lam_new = jnp.clip(st.sigma * (zeta - zhat),
                               -alm_cfg.lam_max, alm_cfg.lam_max)
            need_more = (jnp.abs(e) > alm_cfg.delta) \
                & (jnp.abs(e) > alm_cfg.theta * jnp.abs(st.e_prev))
            sigma_new = jnp.where(
                need_more,
                jnp.minimum(st.sigma * alm_cfg.penalty_factor,
                            alm_cfg.sigma_max),
                st.sigma)
            done = res.converged & (viol <= alm_cfg.delta)
            st_new = _St(
                u=res.us, lam=lam_new, sigma=sigma_new,
                e_prev=jnp.abs(e), psi=res.cost,
                outer=st.outer + 1,
                inner_total=st.inner_total + res.iterations,
                failures=st.failures + (~res.converged).astype(jnp.int32),
                converged=done, violation=viol)
            return _bwhere(active, st_new, st)

        st = jax.lax.while_loop(cond, body, st0)
        sigma_out = _bwhere(skip, sigma_in, st.sigma)
        return AlmResult(
            u=st.u, lam=st.lam, psi=st.psi, converged=st.converged,
            outer_iterations=st.outer, inner_iterations=st.inner_total,
            constraint_violation=st.violation,
            inner_convergence_failures=st.failures,
            sigma=sigma_out, gamma=jnp.zeros((Bb,), dtype),
            inner_trace=None)

    return pinned_precision(solve)


# ---------------------------------------------------------------------------
# Batched MPC controller over the sharded solver
# ---------------------------------------------------------------------------

class BatchedMpcStepOut(NamedTuple):
    carry: Any
    u0: jnp.ndarray          # (B, input_dim) first optimal inputs
    result: Any              # batched AlmResult


@dataclasses.dataclass(frozen=True)
class BatchedMpcController:
    """Batch-native MPC controller (counterpart of control.mpc.MpcController
    with a leading scenario axis, reference: controller.py:10-69): carries
    warm starts for B lanes at once so its solver can run mesh-sharded —
    the per-lane controller's ``vmap`` would trace the solver per lane and
    could never reach a ``shard_map`` spanning the batch."""
    solve: Callable
    n_horiz: int
    input_dim: int
    m: int
    warm_start_input: tuple

    def init_carry(self, batch: int, dtype=jnp.float32):
        from mpc_tpu.control.mpc import MpcCarry
        U0 = jnp.tile(jnp.asarray(self.warm_start_input, dtype),
                      (batch, self.n_horiz))
        return MpcCarry(
            U=U0,
            lam=jnp.zeros((batch, self.m), dtype),
            sigma=jnp.zeros((batch, self.m), dtype),
            gamma=jnp.zeros((batch,), dtype),
            tot_it=jnp.zeros((batch,), jnp.int32),
            failures=jnp.zeros((batch,), jnp.int32),
        )

    def step(self, carry, param) -> BatchedMpcStepOut:
        from mpc_tpu.control.mpc import MpcCarry
        res = self.solve(param, carry.U, carry.lam, sigma0=carry.sigma,
                         gamma0=carry.gamma)
        ok = res.converged
        new_carry = MpcCarry(
            U=res.u, lam=res.lam,
            sigma=_bwhere(ok, res.sigma, jnp.zeros_like(res.sigma)),
            gamma=_bwhere(ok, res.gamma, jnp.zeros_like(res.gamma)),
            tot_it=carry.tot_it + res.inner_iterations,
            failures=carry.failures + (~res.converged).astype(jnp.int32),
        )
        return BatchedMpcStepOut(new_carry, res.u[:, : self.input_dim], res)

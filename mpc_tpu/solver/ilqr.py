"""Iterative LQR with a parallel-scan Riccati backward pass (AL-iLQR).

Second solver family next to ALM+PANOC (solver/alm.py, solver/panoc.py),
specialized for the OCP structure the reference's alpaqa solver never
exploits (it sees only a flat box-constrained NLP, controller.py:27-48):

- backward pass: time-varying LQT on the linearized/quadraticized problem,
  solved by the associative-scan Riccati (solver/lqr.py) — O(log N)
  sequential depth on the horizon axis;
- derivatives: per-stage Jacobians/Hessians are embarrassingly parallel
  (one vmap over stages — no N-deep AD chain);
- forward pass: nonlinear closed-loop rollout under a *parallel candidate
  fan* of line-search step sizes (the same fan trick as solver/panoc.py) —
  one batched scan instead of a sequential backtracking loop;
- state constraints: augmented-Lagrangian penalties folded into the stage
  cost per stage (AL-iLQR, the ALTRO recipe) so the ALM outer layer
  (lam/sigma updates) can wrap this inner solver exactly like PANOC;
- input box: clamped in the forward rollout (projected iLQR). Exactness at
  the bounds comes from the ALM wrapper only penalizing *state*
  constraints; the input box is handled by clamping both the nominal and
  the perturbed rollouts, which keeps iterates feasible w.r.t. C at all
  times (same guarantee as PANOC's projection).

Everything is fixed-shape and mask-converged: jit, vmap over scenarios,
shard over a mesh.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from mpc_tpu.solver.lqr import lqt_solve_parallel, lqt_solve_sequential
from mpc_tpu.solver.precision import pinned_precision
from mpc_tpu.solver.problem import Box, default_unroll


class IlqrConfig(NamedTuple):
    max_iter: int = 40
    tol_grad: float = 1e-4        # ||l_u + B'V_x||_inf stationarity proxy
    tol_dcost: float = 1e-7       # relative cost-decrease exit
    # Stall exit tolerance (rejected step, best candidate within tol_stall
    # relative of the current cost). Looser than tol_dcost by design: f32
    # line-search candidates carry ~1e-7 relative noise, so a lane at the
    # f32 optimum sees rejections with rel just above 1e-7 — it must still
    # be allowed to declare the stall before reg grows past reg_conv_max.
    tol_stall: float = 2e-6
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
    reg_init: float = 1e-3
    reg_min: float = 1e-6
    reg_max: float = 1e8
    reg_up: float = 8.0
    reg_down: float = 0.5
    # Convergence exits are only claimable while reg <= reg_conv_max: the
    # gnorm proxy comes from the LQT solved with Rr = R + reg*I, and at
    # large reg both ko (~1/reg) and the step sizes vanish, so a lane stuck
    # rejecting steps would otherwise satisfy the gnorm/stalled exits at a
    # non-stationary point and poison the MPC warm-start carry.
    reg_conv_max: float = 1.0
    # Per-iteration history buffers (IlqrTrace), NaN past the used prefix —
    # same semantics as solver/panoc.py's PanocTrace.
    trace: bool = False
    # Backward pass: associative-scan Riccati (O(log N) sequential depth) vs
    # the classic sequential recursion. Default sequential: at throughput
    # batches the scan's batched 6x6 LU solves per combine level cost more
    # than the sequential pass saves in depth. The parallel scan is meant
    # for batches too small to fill the device (latency-bound single-lane
    # solves) and for the mesh-sharded horizon (parallel/lqr_sharded.py).
    # Neither side has been timed on the GPU yet (ROADMAP S11).
    parallel_backward: bool = False
    # scan unroll for the sequential nonlinear rollouts (rollout/forward)
    # and the sequential Riccati; None -> solver/problem.py default_unroll.
    unroll: Optional[int] = None
    # Gauss-Newton curvature: when the stage cost has a residual form
    # (L = sum r_i^2, e.g. the vehicle tracking cost), use 2 J'J / 2 J'r
    # from ONE forward-Jacobian pass instead of full second-order AD
    # through the rollout+centerline scan. PSD by construction and much
    # cheaper; exact at zero residual (classic GN).
    gauss_newton: bool = True


def _assert_stage_uniform(v, n_horiz: int, width: int, name: str) -> None:
    """The iLQR family folds boxes/bounds per stage using stage 0's row;
    per-stage bounds (which Box supports and solver/alm.py honors) would be
    silently mis-applied — reject them at build time."""
    import numpy as np
    arr = np.asarray(v).reshape(n_horiz, width)
    if not (np.all(arr == arr[0]) or np.all(np.isnan(arr))):
        raise ValueError(
            f"{name}: the iLQR solver family requires stage-uniform bounds "
            f"(all {n_horiz} stages identical); got per-stage values. Use "
            f"the ALM+PANOC family (solver/alm.py) for per-stage boxes.")


def resolve_unroll(cfg: IlqrConfig, n_horiz: int) -> int:
    """``cfg.unroll``, or the library policy when it is None."""
    return default_unroll(n_horiz) if cfg.unroll is None else cfg.unroll


class IlqrTrace(NamedTuple):
    """Per-iteration history (``IlqrConfig.trace=True``).

    Fixed-size buffers of length ``max_iter``; rows past ``iterations``
    keep NaN (jit/vmap-safe shapes) — the iLQR-family counterpart of
    :class:`~mpc_tpu.solver.panoc.PanocTrace`, replacing alpaqa's streaming
    progress callback (reference: controller.py:23-24,38)."""
    cost: jnp.ndarray       # (max_iter,) accepted cost after each iteration
    grad_norm: jnp.ndarray  # (max_iter,) max|ko| stationarity proxy
    reg: jnp.ndarray        # (max_iter,) regularization entering the iter
    alpha: jnp.ndarray      # (max_iter,) chosen step size (NaN if rejected)


class IlqrResult(NamedTuple):
    us: jnp.ndarray          # (N, m) optimal input sequence
    xs: jnp.ndarray          # (N+1, n) corresponding trajectory
    cost: jnp.ndarray
    converged: jnp.ndarray
    iterations: jnp.ndarray
    grad_norm: jnp.ndarray
    trace: Any = None        # IlqrTrace when cfg.trace


class _State(NamedTuple):
    us: jnp.ndarray
    xs: jnp.ndarray
    cost: jnp.ndarray
    reg: jnp.ndarray
    iters: jnp.ndarray
    converged: jnp.ndarray
    grad_norm: jnp.ndarray
    trace: Any = None


def make_ilqr_solver(f_d: Callable, stage_cost: Callable, n_horiz: int,
                     state_dim: int, input_dim: int,
                     u_box: Optional[Box] = None,
                     cfg: IlqrConfig = IlqrConfig(),
                     stage_residuals: Optional[Callable] = None) -> Callable:
    """Build ``solve(us0, param, al_args=None) -> IlqrResult``.

    ``f_d(x, u, p) -> x_next`` is the discrete dynamics;
    ``stage_cost(x_next, u, param)`` is evaluated on the post-input state
    (the build_ocp_problem convention — the cost of stage k sees
    x_{k+1} = f_d(x_k, u_k)).

    ``al_args``, when given, is ``(lam, sigma, stage_al[, stage_al_res])``
    with ``stage_al(x_next, u, param, lam_k, sigma_k) -> scalar`` added to
    every stage cost — the per-stage augmented-Lagrangian hook for AL-iLQR
    (lam/sigma rows per stage, shape (N, n_c)) — and ``stage_al_res`` its
    residual form (AL term == sum(res**2)).

    ``stage_residuals(x_next, u, param) -> (k,)``, when given with
    ``cfg.gauss_newton``, must satisfy ``stage_cost == sum(residuals**2)``;
    the backward pass then uses Gauss-Newton curvature from one
    forward-Jacobian pass (no second-order AD).
    """
    unroll = resolve_unroll(cfg, n_horiz)
    if cfg.parallel_backward:
        lqt = lqt_solve_parallel
    else:
        lqt = functools.partial(lqt_solve_sequential, unroll=unroll)

    if u_box is not None:
        # clamp() reuses stage 0's bounds for every stage; reject per-stage
        # boxes at build time instead of silently clamping them wrong.
        _assert_stage_uniform(u_box.lower, n_horiz, input_dim, "u_box.lower")
        _assert_stage_uniform(u_box.upper, n_horiz, input_dim, "u_box.upper")

    def clamp(u):
        if u_box is None:
            return u
        lo = u_box.lower[:input_dim]
        hi = u_box.upper[:input_dim]
        return jnp.clip(u, lo, hi)

    def solve(us0: jnp.ndarray, param: Any, al_args=None,
              skip=None) -> IlqrResult:
        dtype = us0.dtype
        us0 = us0.reshape(n_horiz, input_dim)

        stage_al = stage_al_res = None
        if al_args is not None:
            lam, sigma, stage_al, *rest = al_args
            stage_al_res = rest[0] if rest else None
            lam = lam.reshape(n_horiz, -1)
            sigma = sigma.reshape(n_horiz, -1)
        use_gn = (cfg.gauss_newton and stage_residuals is not None
                  and (al_args is None or stage_al_res is not None))

        def fr_k(x, u, k):
            """(x_next, residual vector r) with stage cost == sum(r**2)."""
            xn = f_d(x, u, param["p"])
            r = stage_residuals(xn, u, param)
            if stage_al_res is not None:
                r = jnp.concatenate(
                    [r, stage_al_res(xn, u, param, lam[k], sigma[k])])
            return xn, r

        if use_gn:
            def l_k(x, u, k):
                return jnp.sum(fr_k(x, u, k)[1] ** 2)
        elif al_args is None:
            def l_k(x, u, k):
                return stage_cost(f_d(x, u, param["p"]), u, param)
        else:
            def l_k(x, u, k):
                xn = f_d(x, u, param["p"])
                return stage_cost(xn, u, param) \
                    + stage_al(xn, u, param, lam[k], sigma[k])

        def rollout(us):
            def step(x, uk):
                u, k = uk
                xn = f_d(x, clamp(u), param["p"])
                return xn, (xn, l_k(x, clamp(u), k))
            _, (xs_tail, ls) = jax.lax.scan(
                step, param["y0"], (us, jnp.arange(n_horiz)), unroll=unroll)
            xs = jnp.concatenate([param["y0"][None], xs_tail], axis=0)
            return xs, jnp.sum(ls)

        def derivatives(xs, us):
            """Per-stage (A, B, Q, q, R, r, P) — one vmap, no serial chain."""
            if use_gn:
                def one(x, u, k):
                    # ONE jacfwd pass shares the (n+m) tangents between the
                    # dynamics Jacobians and the residual Jacobians.
                    (A, B), (Jx, Ju) = jax.jacfwd(
                        lambda x_, u_: fr_k(x_, u_, k), argnums=(0, 1))(x, u)
                    r = fr_k(x, u, k)[1]
                    return (A, B,
                            2.0 * Jx.T @ Jx, 2.0 * Jx.T @ r,
                            2.0 * Ju.T @ Ju, 2.0 * Ju.T @ r,
                            2.0 * Ju.T @ Jx)
            else:
                def one(x, u, k):
                    A = jax.jacfwd(lambda x_: f_d(x_, u, param["p"]))(x)
                    B = jax.jacfwd(lambda u_: f_d(x, u_, param["p"]))(u)
                    lx, lu = jax.grad(l_k, argnums=(0, 1))(x, u, k)
                    (lxx, lxu), (lux, luu) = jax.hessian(l_k, argnums=(0, 1))(
                        x, u, k)
                    return A, B, lxx, lx, luu, lu, lux
            return jax.vmap(one)(xs[:-1], us, jnp.arange(n_horiz))

        def backward(xs, us, reg):
            A, B, Q, q, R, r, P = derivatives(xs, us)
            Rr = R + reg * jnp.eye(input_dim, dtype=dtype)
            # Q blocks need only be PSD enough for the Riccati to stay
            # bounded; the reg on R plus the line search absorb mild
            # indefiniteness (standard iLQR regularization).
            c = jnp.zeros((n_horiz, state_dim), dtype)
            QN = jnp.zeros((state_dim, state_dim), dtype)
            qN = jnp.zeros((state_dim,), dtype)
            sol = lqt(jnp.zeros((state_dim,), dtype), A, B, c, Q, q, Rr, r,
                      QN, qN, P=P)
            # deviation-space affine policy du = -Ko dx - ko; at the
            # optimum the zero-deviation action ko vanishes — its norm is
            # the stationarity proxy.
            return sol.Ko, sol.ko, jnp.max(jnp.abs(sol.ko))

        def forward(xs, us, Ks, kos, alpha):
            def step(x, inp):
                x_nom, u_nom, K, ko, k = inp
                u = clamp(u_nom - alpha * ko
                          - (K @ (x - x_nom)[..., None])[..., 0])
                xn = f_d(x, u, param["p"])
                return xn, (xn, u, l_k(x, u, k))
            _, (xs_t, us_n, ls) = jax.lax.scan(
                step, param["y0"],
                (xs[:-1], us, Ks, kos, jnp.arange(n_horiz)), unroll=unroll)
            xs_n = jnp.concatenate([param["y0"][None], xs_t], axis=0)
            return xs_n, us_n, jnp.sum(ls)

        xs0, cost0 = rollout(us0)
        # skip (traced bool): event-triggered lanes pass tol=+inf through the
        # AL wrapper; such lanes must exit before iteration 0 with the inputs
        # unchanged (solver/alm.py:112-118 contract).
        skip_ = (jnp.zeros((), bool) if skip is None
                 else jnp.asarray(skip, bool))
        us_init = jnp.where(skip_, us0, clamp(us0))
        tr0 = None
        if cfg.trace:
            nanbuf = jnp.full((cfg.max_iter,), jnp.nan, dtype)
            tr0 = IlqrTrace(cost=nanbuf, grad_norm=nanbuf, reg=nanbuf,
                            alpha=nanbuf)
        st0 = _State(us=us_init, xs=xs0, cost=cost0,
                     reg=jnp.asarray(cfg.reg_init, dtype),
                     iters=jnp.zeros((), jnp.int32),
                     converged=skip_,
                     grad_norm=jnp.full((), jnp.inf, dtype),
                     trace=tr0)

        alphas = jnp.asarray(cfg.alphas, dtype)

        def cond(st: _State):
            return (~st.converged) & (st.iters < cfg.max_iter) \
                & (st.reg < cfg.reg_max)

        def body(st: _State) -> _State:
            Ks, kffs, gnorm = backward(st.xs, st.us, st.reg)
            xs_f, us_f, costs = jax.vmap(
                lambda a: forward(st.xs, st.us, Ks, kffs, a))(alphas)
            costs = jnp.where(jnp.isnan(costs), jnp.inf, costs)
            best = jnp.argmin(costs)
            improved = costs[best] < st.cost - 1e-12

            dcost = st.cost - costs[best]
            rel = jnp.abs(dcost) / (jnp.abs(st.cost) + 1e-12)
            # Stall = no candidate strictly improves but the best matches the
            # current cost to tolerance: at a box-saturated optimum every
            # alpha re-clamps to the same inputs, so this IS convergence
            # (ko never vanishes in the unclamped deviation space there).
            stalled = (~improved) & (rel < cfg.tol_stall)
            # All exits gated on moderate regularization: at large reg both
            # gnorm (~1/reg) and the steps vanish regardless of
            # stationarity, so a rejection-stuck lane must keep iterating
            # (or exit non-converged via reg_max) rather than claim success.
            reg_ok = st.reg <= cfg.reg_conv_max
            conv = ((improved & (rel < cfg.tol_dcost))
                    | (gnorm <= cfg.tol_grad) | stalled) & reg_ok

            st_acc = st._replace(
                us=us_f[best], xs=xs_f[best], cost=costs[best],
                reg=jnp.maximum(st.reg * cfg.reg_down, cfg.reg_min),
                converged=conv, grad_norm=gnorm)
            st_rej = st._replace(reg=st.reg * cfg.reg_up,
                                 converged=conv, grad_norm=gnorm)
            st_new = jax.tree_util.tree_map(
                lambda a, b: jnp.where(jnp.reshape(improved, (1,) * a.ndim),
                                       a, b), st_acc, st_rej)
            if cfg.trace:
                k = st.iters
                tr = st.trace
                st_new = st_new._replace(trace=IlqrTrace(
                    cost=tr.cost.at[k].set(st_new.cost),
                    grad_norm=tr.grad_norm.at[k].set(gnorm),
                    reg=tr.reg.at[k].set(st.reg),
                    alpha=tr.alpha.at[k].set(
                        jnp.where(improved, alphas[best], jnp.nan))))
            return st_new._replace(iters=st.iters + 1)

        st = jax.lax.while_loop(cond, body, st0)
        return IlqrResult(us=st.us.reshape(-1), xs=st.xs, cost=st.cost,
                          converged=st.converged,
                          iterations=st.iters, grad_norm=st.grad_norm,
                          trace=st.trace)

    return pinned_precision(solve)


# ---------------------------------------------------------------------------
# AL-iLQR: augmented-Lagrangian outer loop around the iLQR inner solver
# ---------------------------------------------------------------------------

def make_al_ilqr_solver(f_d: Callable, stage_cost: Callable, n_horiz: int,
                        state_dim: int, input_dim: int,
                        u_box: Box,
                        stage_constraints: Optional[Callable] = None,
                        n_stage_constraints: int = 0,
                        D: Optional[Box] = None,
                        alm_cfg=None, ilqr_cfg: IlqrConfig = IlqrConfig(),
                        stage_residuals: Optional[Callable] = None):
    """Build an AL-iLQR ``solve(param, u0, lam0, sigma0=, gamma0=) -> AlmResult``.

    Drop-in alternative to solver/alm.py's PANOC-based solver for OCPs with
    per-stage state constraints (the ALTRO recipe): the inner minimization
    over the input-box C runs iLQR with the shifted-penalty AL folded into
    each stage cost; the outer loop updates lam/sigma with the exact
    semantics of solver/alm.py (same delta/theta/penalty_factor, per-lane
    warm-started sigma, capped carry). Input boxes are enforced by clamping
    inside the rollouts; state constraints converge through the multipliers.

    Returns results in solver/alm.py's AlmResult shape so MpcController can
    drive either solver unchanged.
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
        inner = make_ilqr_solver(f_d, stage_cost, n_horiz, state_dim,
                                 input_dim, u_box=u_box, cfg=ilqr_cfg,
                                 stage_residuals=stage_residuals)

        def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
            # tol > 1e30 is the lane-skip sentinel (solver/alm.py contract,
            # used by event-triggered MPC): exit converged at zero
            # iterations with the inputs unchanged.
            dtype = u0.dtype
            skip = None if tol is None else \
                jnp.asarray(tol, dtype) > jnp.asarray(1e30, dtype)
            res = inner(u0, param, skip=skip)
            sigma = sigma0 if sigma0 is not None else jnp.zeros((0,), dtype)
            return AlmResult(
                u=res.us, lam=lam0, psi=res.cost, converged=res.converged,
                outer_iterations=(res.iterations > 0).astype(jnp.int32),
                inner_iterations=res.iterations,
                constraint_violation=jnp.zeros((), dtype),
                inner_convergence_failures=(~res.converged).astype(jnp.int32),
                sigma=sigma,
                gamma=jnp.zeros((), dtype),
                inner_trace=res.trace)

        return pinned_precision(solve)

    # Stage AL term: shifted quadratic penalty for g(x_next) in D, one row
    # of (lam, sigma) per stage (same formula as solver/alm.py, decomposed
    # stage-wise so the iLQR Hessians stay per-stage). Stage 0's bounds are
    # reused for every stage — per-stage D is rejected at build time.
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
        # residual form: stage_al == sum(res**2); clip is piecewise linear
        # so the GN Jacobian is exact on the active/inactive pieces
        g = stage_constraints(xn, u, param)
        zeta = g + lam_k / sigma_k
        zhat = jnp.clip(zeta, D_lo, D_hi)
        return jnp.sqrt(0.5 * sigma_k) * (zeta - zhat)

    inner = make_ilqr_solver(f_d, stage_cost, n_horiz, state_dim, input_dim,
                             u_box=u_box, cfg=ilqr_cfg,
                             stage_residuals=stage_residuals)

    def constraints_from_traj(xs, us_flat, param):
        """g evaluated on the inner solve's accepted trajectory — no extra
        N-deep rollout per outer iteration (the inner iLQR already returns
        xs; stage k's constraint sees x_{k+1}, the build_ocp_problem
        convention)."""
        us = us_flat.reshape(n_horiz, input_dim)
        gs = jax.vmap(lambda xn, u: stage_constraints(xn, u, param))(
            xs[1:], us)
        return gs.reshape(-1)

    class _St(NamedTuple):
        u: jnp.ndarray
        lam: jnp.ndarray
        sigma: jnp.ndarray
        e_prev: jnp.ndarray
        psi: jnp.ndarray
        outer: jnp.ndarray
        inner_total: jnp.ndarray
        failures: jnp.ndarray
        converged: jnp.ndarray
        violation: jnp.ndarray
        inner_trace: Any = None   # IlqrTrace of the LAST inner solve

    def solve(param, u0, lam0, tol=None, sigma0=None, gamma0=None):
        dtype = u0.dtype
        # tol > 1e30 = lane-skip sentinel (solver/alm.py:112-118 contract):
        # the outer while_loop starts converged, so a skipped lane costs
        # zero outer/inner iterations and keeps u/lam/sigma unchanged.
        skip = (jnp.zeros((), bool) if tol is None
                else jnp.asarray(tol, dtype) > jnp.asarray(1e30, dtype))
        sigma_cold = jnp.broadcast_to(
            jnp.asarray(alm_cfg.sigma_0, dtype), (m,))
        if sigma0 is None:
            sigma_in = jnp.zeros((m,), dtype)
            sigma_init = sigma_cold
        else:
            sigma_in = sigma0.astype(dtype)
            warm = jnp.all(sigma_in > 0)
            sigma_init = jnp.where(
                warm, jnp.minimum(jnp.maximum(sigma_in, 1e-12), sigma_cold),
                sigma_cold)

        st0 = _St(u=u0, lam=lam0.astype(dtype), sigma=sigma_init,
                  e_prev=jnp.full((m,), jnp.inf, dtype),
                  psi=jnp.zeros((), dtype),
                  outer=jnp.zeros((), jnp.int32),
                  inner_total=jnp.zeros((), jnp.int32),
                  failures=jnp.zeros((), jnp.int32),
                  converged=skip,
                  violation=jnp.full((), jnp.inf, dtype),
                  inner_trace=(IlqrTrace(
                      *([jnp.full((ilqr_cfg.max_iter,), jnp.nan, dtype)] * 4))
                      if ilqr_cfg.trace else None))

        def cond(st):
            return (~st.converged) & (st.outer < alm_cfg.max_iter)

        def body(st):
            res = inner(st.u, param,
                        al_args=(st.lam, st.sigma, stage_al, stage_al_res))
            g = constraints_from_traj(res.xs, res.us, param)
            zeta = g + st.lam / st.sigma
            zhat = project(zeta, D)
            e = g - zhat
            viol = jnp.max(jnp.abs(e))
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
                converged=done, violation=viol,
                inner_trace=res.trace if ilqr_cfg.trace else None)
            return jax.tree_util.tree_map(
                lambda a, b: jnp.where(jnp.reshape(st.converged,
                                                   (1,) * a.ndim), a, b),
                st, st_new)

        st = jax.lax.while_loop(cond, body, st0)
        # Skipped lanes never solved: preserve the raw incoming sigma so a
        # cold (sigma=0) lane stays cold for its next real solve.
        sigma_out = jnp.where(skip, sigma_in, st.sigma)
        return AlmResult(
            u=st.u, lam=st.lam, psi=st.psi, converged=st.converged,
            outer_iterations=st.outer, inner_iterations=st.inner_total,
            constraint_violation=st.violation,
            inner_convergence_failures=st.failures,
            sigma=sigma_out, gamma=jnp.zeros((), dtype),
            inner_trace=st.inner_trace)

    return pinned_precision(solve)

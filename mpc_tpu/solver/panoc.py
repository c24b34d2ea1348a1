"""PANOC inner solver with L-BFGS acceleration — pure JAX, batched, jit/vmap-able.

Replaces alpaqa's C++ ``StructuredPANOCLBFGSSolver``
(reference: controller.py:27-37): projected-gradient (forward-backward) steps
on the box C, accelerated by an L-BFGS model of the fixed-point residual,
with the ``ProjGradNorm2`` stopping criterion ``||u - Pi_C(u - g*grad)|| / g``
and an L-BFGS memory of ``N_horiz`` (controller.py:36).

Design decisions (vs a line-by-line translation of the C++):
- Fixed shapes everywhere: the L-BFGS history is a static ring buffer with
  validity masks; iteration runs in a ``lax.while_loop`` with a static cap,
  so the whole solver jits, vmaps over scenario batches, and shards over a
  device mesh.
- The sequential line search is replaced by *parallel candidate evaluation*:
  each iteration evaluates the L-BFGS candidate ``u + d`` and the safe
  forward-backward fallback ``u_hat`` in one batched value_and_grad call and
  keeps the lower forward-backward-envelope (FBE) value. Since
  ``FBE(u_hat) <= FBE(u) - sigma*||r||^2`` whenever the quadratic upper bound
  holds, global convergence is inherited while the accelerated step is taken
  whenever it helps — no data-dependent inner loop.
- Step-size (Lipschitz) backtracking is folded into the main loop: an
  iteration either halves ``gamma`` (flushing the L-BFGS history, as alpaqa
  does on step-size changes) or takes a step. Wall-clock caps
  (controller.py:30) are replaced by the static iteration cap.
- Per-scenario convergence is a mask — one diverging scenario cannot stall a
  batch (each lane freezes once converged).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

from mpc_tpu.config import PanocConfig
from mpc_tpu.solver.problem import Box, project


# ---------------------------------------------------------------------------
# L-BFGS ring buffer (static memory, masked validity)
# ---------------------------------------------------------------------------

class LbfgsState(NamedTuple):
    S: jnp.ndarray       # (M, n) steps s_k
    Y: jnp.ndarray       # (M, n) residual differences y_k
    rho: jnp.ndarray     # (M,)   1 / (s_k . y_k)
    valid: jnp.ndarray   # (M,)   bool
    head: jnp.ndarray    # ()     next write slot


def lbfgs_init(memory: int, n: int, dtype=jnp.float32) -> LbfgsState:
    return LbfgsState(
        S=jnp.zeros((memory, n), dtype),
        Y=jnp.zeros((memory, n), dtype),
        rho=jnp.zeros((memory,), dtype),
        valid=jnp.zeros((memory,), bool),
        head=jnp.zeros((), jnp.int32),
    )


def lbfgs_flush(st: LbfgsState) -> LbfgsState:
    return st._replace(valid=jnp.zeros_like(st.valid), head=jnp.zeros_like(st.head))


def lbfgs_push(st: LbfgsState, s: jnp.ndarray, y: jnp.ndarray,
               min_step: jnp.ndarray = 0.0) -> LbfgsState:
    """Insert a curvature pair; skipped when s.y fails the curvature condition.

    ``min_step``: f32 noise floor for the step norm. A pair whose step is
    rounding noise (iterate crawling at the float32 floor) carries no real
    curvature — s.y ~ 1e-14 still passes the *relative* curvature check, so
    rho = 1/(s.y) explodes and the two-loop recursion emits astronomically
    long directions (measured: ||d|| ~ 1e9 ||r||, launching the iterate into
    a Pacejka blow-up region). Such pairs are skipped.
    """
    sy = jnp.dot(s, y)
    sn = jnp.linalg.norm(s)
    good = (sy > 1e-10 * sn * jnp.linalg.norm(y)) & (sn > min_step)
    safe_sy = jnp.where(good, sy, 1.0)
    S = jnp.where(good, st.S.at[st.head].set(s), st.S)
    Y = jnp.where(good, st.Y.at[st.head].set(y), st.Y)
    rho = jnp.where(good, st.rho.at[st.head].set(1.0 / safe_sy), st.rho)
    valid = jnp.where(good, st.valid.at[st.head].set(True), st.valid)
    head = jnp.where(good, (st.head + 1) % st.S.shape[0], st.head)
    return LbfgsState(S, Y, rho, valid, head)


def lbfgs_direction(st: LbfgsState, q: jnp.ndarray) -> jnp.ndarray:
    """Two-loop recursion: returns d = -H q (statically unrolled over memory)."""
    M = st.S.shape[0]
    alphas = []
    for j in range(M):                       # newest -> oldest
        i = (st.head - 1 - j) % M
        m = st.valid[i]
        a = jnp.where(m, st.rho[i] * jnp.dot(st.S[i], q), 0.0)
        q = q - a * jnp.where(m, 1.0, 0.0) * st.Y[i]
        alphas.append((i, m, a))

    # Initial Hessian scaling from the newest valid pair.
    i0 = (st.head - 1) % M
    yy = jnp.dot(st.Y[i0], st.Y[i0])
    sy = jnp.dot(st.S[i0], st.Y[i0])
    h0 = jnp.where(st.valid[i0] & (yy > 0), sy / jnp.maximum(yy, 1e-30), 1.0)
    q = q * h0

    for i, m, a in reversed(alphas):         # oldest -> newest
        b = jnp.where(m, st.rho[i] * jnp.dot(st.Y[i], q), 0.0)
        q = q + (a - b) * jnp.where(m, 1.0, 0.0) * st.S[i]
    return -q


# ---------------------------------------------------------------------------
# PANOC
# ---------------------------------------------------------------------------

class PanocTrace(NamedTuple):
    """Optional per-iterate history (``PanocConfig.trace=True``).

    Fixed-size buffers of length ``max_iter`` (static — jit/vmap/scan safe);
    rows past ``iterations`` keep NaN. The JAX-native replacement for
    alpaqa's streaming progress callback (reference: controller.py:23-24,38)
    — debugging a divergent lane means reading its buffer instead of
    grepping prints.
    """
    psi: jnp.ndarray        # (max_iter,) objective per iterate
    criterion: jnp.ndarray  # (max_iter,) ||r||/gamma per iterate
    gamma: jnp.ndarray      # (max_iter,) step size per iterate


class PanocResult(NamedTuple):
    u: jnp.ndarray
    psi: jnp.ndarray
    converged: jnp.ndarray
    iterations: jnp.ndarray
    criterion: jnp.ndarray   # final ||r||/gamma (ProjGradNorm2)
    gamma: jnp.ndarray       # final step size — warm-start carry
    trace: Any = None        # PanocTrace when cfg.trace, else None


class _State(NamedTuple):
    u: jnp.ndarray
    psi: jnp.ndarray
    grad: jnp.ndarray
    gamma: jnp.ndarray
    lbfgs: LbfgsState
    iters: jnp.ndarray
    converged: jnp.ndarray
    criterion: jnp.ndarray
    stalled: jnp.ndarray     # consecutive iterations with zero movement
    best_crit: jnp.ndarray   # best criterion seen (plateau detection)
    plateau: jnp.ndarray     # consecutive iterations without a new best
    trace: Any = None        # PanocTrace buffers when enabled


def _tree_where(pred, a, b):
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(jnp.reshape(pred, (1,) * x.ndim), x, y), a, b)


def make_panoc_solver(psi_vg: Callable[[jnp.ndarray, Any], tuple],
                      C: Box, cfg: PanocConfig,
                      progress_callback: Callable = None) -> Callable:
    """Build ``solve(u0, tol, args) -> PanocResult``.

    ``psi_vg(u, args) -> (psi, grad)`` is the value-and-gradient of the smooth
    objective (plain cost, or the augmented Lagrangian when called from ALM).
    ``progress_callback(iteration, psi, criterion, gamma)``, when given, is
    streamed per inner iterate via ``jax.debug.callback`` — the direct
    analogue of alpaqa's progress callback (reference: controller.py:23-24),
    for interactive debugging; prefer ``cfg.trace`` in compiled sweeps.
    The returned ``solve`` is jit-able and vmap-able over ``(u0, args)``.
    """
    cand_vg = jax.vmap(psi_vg, in_axes=(0, None))

    def fbe(u_c, psi_c, grad_c, gamma):
        """Forward-backward envelope phi_gamma at a point."""
        uh = project(u_c - gamma * grad_c, C)
        diff = uh - u_c
        return psi_c + jnp.dot(grad_c, diff) + jnp.dot(diff, diff) / (2.0 * gamma)

    def solve(u0: jnp.ndarray, tol, args, gamma_init=None) -> PanocResult:
        dtype = u0.dtype
        u0 = project(u0, C)

        # Initial step size from a finite-difference Lipschitz estimate
        # (stand-in for alpaqa's hessian_step_size_heuristic, controller.py:33).
        # Both points go through the candidate-fan evaluator in one call.
        h = 1e-4 * (1.0 + jnp.abs(u0))
        psis0, grads0 = cand_vg(jnp.stack([u0, u0 + h]), args)
        psi0, g0, g_h = psis0[0], grads0[0], grads0[1]
        L0 = jnp.linalg.norm(g_h - g0) / jnp.maximum(jnp.linalg.norm(h), 1e-30)
        L0 = jnp.clip(L0, 1e-8, 1e15)
        gamma0 = jnp.asarray(cfg.alpha, dtype) / L0
        if gamma_init is not None:
            # Warm-started step size (MPC steady state): positive entries
            # override the estimate; non-positive (cold) lanes keep it.
            # Clipped against the fresh estimate: a carried gamma can only
            # ever shrink inside the loop (QUB halving), so without the
            # lower clip one hard transient would depress the step size for
            # the rest of a rollout; above the fresh estimate it is stale
            # (the QUB check would just re-halve it back down).
            g_warm = jnp.clip(gamma_init.astype(dtype),
                              gamma0 / 64.0, gamma0)
            gamma0 = jnp.where(gamma_init > 0, g_warm, gamma0)

        tr0 = None
        if cfg.trace:
            nanbuf = jnp.full((cfg.max_iter,), jnp.nan, dtype)
            tr0 = PanocTrace(psi=nanbuf, criterion=nanbuf, gamma=nanbuf)
        st0 = _State(
            u=u0, psi=psi0, grad=g0, gamma=gamma0,
            lbfgs=lbfgs_init(cfg.lbfgs_memory, u0.shape[0], dtype),
            iters=jnp.zeros((), jnp.int32),
            converged=jnp.zeros((), bool),
            criterion=jnp.full((), jnp.inf, dtype),
            stalled=jnp.zeros((), jnp.int32),
            best_crit=jnp.full((), jnp.inf, dtype),
            plateau=jnp.zeros((), jnp.int32),
            trace=tr0,
        )

        def cond(st: _State):
            # A lane exits when converged, out of budget, numerically
            # stalled (iterates stopped moving at the float32 floor — no
            # further progress is representable), or plateaued (criterion
            # stopped improving: the fan keeps nudging iterates by an ulp so
            # the stall detector alone misses f32-floor lanes, which would
            # otherwise spin at max_iter).
            return (~st.converged) & (st.iters < cfg.max_iter) \
                & (st.stalled < 3) & (st.plateau < cfg.plateau_iters)

        def body(st: _State) -> _State:
            u, psi_u, g_u, gamma = st.u, st.psi, st.grad, st.gamma

            fw = u - gamma * g_u
            u_hat = project(fw, C)
            r = u - u_hat
            rn2 = jnp.dot(r, r)
            crit = jnp.sqrt(rn2) / gamma
            conv_now = crit <= tol

            tr = st.trace
            if cfg.trace:
                tr = PanocTrace(
                    psi=tr.psi.at[st.iters].set(psi_u),
                    criterion=tr.criterion.at[st.iters].set(crit),
                    gamma=tr.gamma.at[st.iters].set(gamma))
            if progress_callback is not None:
                jax.debug.callback(progress_callback, st.iters, psi_u, crit,
                                   gamma)

            # Structured step (the 'Structured' in alpaqa's
            # StructuredPANOCLBFGSSolver): quasi-Newton only on the FREE
            # variables; active (saturated) coordinates move straight to
            # their bound. Projection kinks on active coordinates would
            # otherwise corrupt the L-BFGS curvature pairs.
            free = (fw > C.lower) & (fw < C.upper)
            fmask = free.astype(u.dtype)
            d_free = lbfgs_direction(st.lbfgs, r * fmask)
            # Trust-region cap: a healthy L-BFGS direction scales with the
            # residual (||d|| ~ cond * ||r||); anything beyond tr_mult * ||r||
            # is a symptom of noise-poisoned curvature pairs, and the FBE
            # merit below is meaningless that far from the iterate. Scale
            # such directions back instead of stepping into the unknown.
            dn = jnp.linalg.norm(d_free)
            cap = cfg.tr_mult * jnp.sqrt(rn2)
            d_free = d_free * jnp.minimum(1.0, cap / jnp.maximum(dn, 1e-30))
            d = jnp.where(free, d_free, -r)
            # Candidate fan: fallback x_hat (tau=0) + the tau grid, all
            # evaluated in one batched call (replaces the sequential line
            # search; see PanocConfig.taus).
            cands = jnp.stack(
                [u_hat] + [u - (1.0 - t) * r + t * d for t in cfg.taus])
            psis, grads = cand_vg(cands, args)
            psi_hat = psis[0]

            # Quadratic upper bound at gamma: psi(u_hat) <= psi(u) - g.r + ||r||^2/(2g).
            # The comparison differences two nearly equal float32 values, so
            # allow ~10x the f32 rounding floor of the operands — otherwise
            # pure noise triggers spurious gamma halving that flushes the
            # L-BFGS history and stalls the solver. (The margin deliberately
            # does NOT model the full evaluation noise of a stiff augmented
            # Lagrangian — penalties must be chosen f32-appropriately
            # instead; see AlmConfig.sigma_0 notes.)
            eps_f = jnp.asarray(jnp.finfo(dtype).eps, dtype)
            margin = 10.0 * eps_f * (jnp.abs(psi_u) + jnp.abs(psi_hat)) + 1e-12
            qub_rhs = psi_u - jnp.dot(g_u, r) + rn2 / (2.0 * gamma) + margin
            gamma_ok = (psi_hat <= qub_rhs) | (gamma <= cfg.gamma_min)

            # --- branch A: halve gamma, flush history, stay put -------------
            st_shrink = st._replace(gamma=gamma * 0.5, lbfgs=lbfgs_flush(st.lbfgs))

            # --- branch B: take the best candidate by FBE -------------------
            phis = jax.vmap(fbe, in_axes=(0, 0, 0, None))(cands, psis, grads, gamma)
            phis = jnp.where(jnp.isnan(phis), jnp.inf, phis)
            # NOTE: no QUB-along-step admissibility filter here. Quasi-Newton
            # candidates legitimately violate the gradient-step quadratic
            # upper bound mid-solve (that is exactly why PANOC uses the FBE
            # merit); filtering on it disables the L-BFGS acceleration
            # (far more iterations per solve on the headline bench).
            # Garbage candidates from noise-poisoned curvature pairs are
            # prevented at the source instead (lbfgs_push min_step + the
            # tr_mult direction cap above).
            best = jnp.argmin(phis)
            u_n, psi_n, g_n = cands[best], psis[best], grads[best]

            r_n = u_n - project(u_n - gamma * g_n, C)
            # Curvature pairs restricted to the free subspace; steps at the
            # f32 rounding floor of the iterate are noise, not curvature.
            min_step = cfg.lbfgs_min_step_mult * eps_f \
                * (1.0 + jnp.linalg.norm(u))
            lb_n = lbfgs_push(st.lbfgs, (u_n - u) * fmask, (r_n - r) * fmask,
                              min_step=min_step)
            moved = jnp.any(u_n != u)
            st_step = st._replace(
                u=u_n, psi=psi_n, grad=g_n, lbfgs=lb_n,
                stalled=jnp.where(moved, 0, st.stalled + 1))

            improved = crit < st.best_crit * 0.999
            st_new = _tree_where(gamma_ok, st_step, st_shrink)
            st_new = st_new._replace(
                iters=st.iters + 1,
                criterion=jnp.minimum(st.criterion, crit),
                best_crit=jnp.minimum(st.best_crit, crit),
                plateau=jnp.where(improved, 0, st.plateau + 1),
                trace=tr,
            )
            # Freeze the lane once converged (batch-safe under vmap).
            st_done = st._replace(converged=jnp.ones((), bool), criterion=crit,
                                  trace=tr)
            return _tree_where(conv_now, st_done, st_new)

        st = jax.lax.while_loop(cond, body, st0)

        # Final criterion refresh (covers the max_iter/stagnation exits).
        u_hat = project(st.u - st.gamma * st.grad, C)
        crit = jnp.linalg.norm(st.u - u_hat) / st.gamma
        # f32-aware stagnation acceptance: computing r = u - P(u - gamma*g)
        # carries an elementwise rounding floor of ~eps_f32*|u|, so
        # ||r||/gamma cannot reliably go below ~eps_f32*||u||/gamma. A lane
        # that exited because its iterates stopped moving (stalled) AND sits
        # within that floor has found the best f32-representable solution —
        # count it converged instead of failing a tolerance that only exists
        # in f64 (alpaqa's eps=1e-6, controller.py:41, is an f64 number).
        # Lanes that stalled far above the floor stay failures.
        eps_f32 = jnp.asarray(jnp.finfo(dtype).eps, dtype)
        floor = cfg.crit_floor_mult * eps_f32 \
            * (1.0 + jnp.linalg.norm(st.u)) / st.gamma
        exhausted = (st.stalled >= 3) | (st.plateau >= cfg.plateau_iters)
        at_floor = exhausted & (crit <= floor)
        return PanocResult(
            u=st.u, psi=st.psi,
            converged=st.converged | (crit <= tol) | at_floor,
            iterations=st.iters,
            criterion=crit,
            gamma=st.gamma,
            trace=st.trace,
        )

    return solve

"""Time-varying LQR/LQT solves — sequential and parallel-scan Riccati.

The horizon-parallel factorization SURVEY.md §5 ("long-context" row) and
§7.5 call for: the backward Riccati recursion of a linear-quadratic tracking
problem is reformulated as an *associative* combination of conditional
value-function elements (Sarkka & Garcia-Fernandez, "Temporal
Parallelization of Bayesian Smoothers", arXiv:1905.13002, Part LQT), so an
N-step backward pass runs in O(log N) sequential depth via
``jax.lax.associative_scan`` instead of O(N) via ``lax.scan``. The forward
rollout of the resulting affine closed-loop system is parallelized the same
way (composition of affine maps is associative).

This is the control-theoretic analogue of blockwise/ring attention for the
MPC horizon axis: the reference has nothing like it (its rollout is a
CasADi ``mapaccum`` chain, reference: car_dynamics.py:159-166) — sequential
depth N per evaluation.

Problem form (general time-varying LQT with affine offsets and linear cost
terms; cross terms handled by completing the square):

    minimize  sum_{k=0}^{N-1} [ 1/2 x_k'Q_k x_k + q_k'x_k
                                + 1/2 u_k'R_k u_k + r_k'u_k + x_k'P_k'u_k ]
              + 1/2 x_N'Q_N x_N + q_N'x_N
    s.t.      x_{k+1} = A_k x_k + B_k u_k + c_k,   x_0 given.

Value function convention: V_k(x) = 1/2 x'S_k x - v_k'x + const.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mpc_tpu.solver.precision import pinned_precision


class LqtSolution(NamedTuple):
    xs: jnp.ndarray    # (N+1, n) optimal state trajectory
    us: jnp.ndarray    # (N, m) optimal inputs
    Ks: jnp.ndarray    # (N, m, n) feedback gains  u~ = -K x - kff (tilde space)
    kffs: jnp.ndarray  # (N, m) feedforward terms (tilde space)
    Ss: jnp.ndarray    # (N+1, n, n) value Hessians
    vs: jnp.ndarray    # (N+1, n) value linear terms (V = 1/2 x'Sx - v'x)
    Ko: jnp.ndarray    # (N, m, n) original-space policy: u = -Ko x - ko
    ko: jnp.ndarray    # (N, m)


def _eliminate_cross_terms(A, B, c, Q, q, R, r, P):
    """Substitute u = u~ - R^{-1}(P x + r): returns the cross-term-free
    (A~, c~, Q~, q~) in the u~ variables. R is unchanged; recovering
    u needs (P, r) again."""
    Rinv_P = jnp.linalg.solve(R, P)              # (m, n)
    Rinv_r = jnp.linalg.solve(R, r[..., None])[..., 0]
    A_t = A - B @ Rinv_P
    c_t = c - B @ Rinv_r
    Q_t = Q - P.T @ Rinv_P
    q_t = q - Rinv_P.T @ r
    return A_t, c_t, Q_t, q_t, Rinv_P, Rinv_r


def _gains(S_next, v_next, A, B, c, R):
    """One-step LQR gain from the next-step value function (tilde space)."""
    BtS = B.T @ S_next
    Quu = R + BtS @ B
    K = jnp.linalg.solve(Quu, BtS @ A)
    kff = jnp.linalg.solve(Quu, (BtS @ c[..., None])[..., 0] - B.T @ v_next)
    return K, kff


def _value_step(S_next, v_next, A, B, c, Q, q, K):
    """Backward Riccati step (tilde space): V_k from V_{k+1} and the gain.

    The feedforward/control-cost cross terms cancel exactly in the linear
    coefficient (K'Quu = A'S_next B), leaving
    v_k = -q + Acl'(v_next - S_next c).
    """
    Acl = A - B @ K
    S = Q + A.T @ S_next @ Acl
    v = -q + Acl.T @ (v_next - (S_next @ c[..., None])[..., 0])
    S = 0.5 * (S + S.T)
    return S, v


@pinned_precision
def lqt_solve_sequential(x0, A, B, c, Q, q, R, r, QN, qN, P=None, unroll=1):
    """Classic O(N)-depth Riccati backward pass + closed-loop forward pass.

    Shapes: A (N,n,n), B (N,n,m), c (N,n), Q (N,n,n), q (N,n), R (N,m,m),
    r (N,m), QN (n,n), qN (n,), optional cross term P (N,m,n).

    ``unroll`` is forwarded to both scans; unrolling fuses blocks of the N
    tiny steps. At throughput batches the whole solve is bound by tiny
    batched matrix ops, where this pass needs far fewer of them than the
    associative scan, whose O(log N) depth pays only when the batch is too
    small to fill the device.
    """
    N, n = A.shape[0], A.shape[1]
    if P is None:
        P = jnp.zeros((N, R.shape[1], n), A.dtype)
    A_t, c_t, Q_t, q_t, Rinv_P, Rinv_r = jax.vmap(_eliminate_cross_terms)(
        A, B, c, Q, q, R, r, P)

    def bwd(carry, inp):
        S_next, v_next = carry
        A_k, B_k, c_k, Q_k, q_k, R_k = inp
        K, kff = _gains(S_next, v_next, A_k, B_k, c_k, R_k)
        S, v = _value_step(S_next, v_next, A_k, B_k, c_k, Q_k, q_k, K)
        return (S, v), (S, v, K, kff)

    (S0, v0), (Ss, vs, Ks, kffs) = jax.lax.scan(
        bwd, (QN, -qN), (A_t, B, c_t, Q_t, q_t, R), reverse=True,
        unroll=unroll)
    Ss = jnp.concatenate([Ss, QN[None]], axis=0)
    vs = jnp.concatenate([vs, -qN[None]], axis=0)

    def fwd(x, inp):
        A_k, B_k, c_k, K, kff, RiP, Rir = inp
        u_t = -(K @ x[..., None])[..., 0] - kff
        u = u_t - (RiP @ x[..., None])[..., 0] - Rir
        x_next = (A_k @ x[..., None])[..., 0] + (B_k @ u[..., None])[..., 0] + c_k
        return x_next, (x_next, u)

    _, (xs_tail, us) = jax.lax.scan(
        fwd, x0, (A, B, c, Ks, kffs, Rinv_P, Rinv_r), unroll=unroll)
    xs = jnp.concatenate([x0[None], xs_tail], axis=0)
    return LqtSolution(xs=xs, us=us, Ks=Ks, kffs=kffs, Ss=Ss, vs=vs,
                       Ko=Ks + Rinv_P, ko=kffs + Rinv_r)


# ---------------------------------------------------------------------------
# Parallel-scan Riccati (associative value-function elements)
# ---------------------------------------------------------------------------
# Element e = (A, b, C, eta, J) represents the conditional cost-to-go of
# traversing a horizon chunk [i, j): starting at x_i, ending at x_j,
#
#   V_{i->j}(x_i, x_j) = stage costs of the chunk, partially minimized,
#
# with x_j = A x_i + b + (noise span C from the minimized controls) and the
# accumulated quadratic (J, eta) in x_i. Combination is associative
# (arXiv:1905.13002 eqs. (45)-(49)); the suffix products e_k (x) ... (x) e_N
# yield V_k(x) = 1/2 x'J x - eta'x directly.


class _Elem(NamedTuple):
    A: jnp.ndarray
    b: jnp.ndarray
    C: jnp.ndarray
    eta: jnp.ndarray
    J: jnp.ndarray


def _combine(ei: _Elem, ej: _Elem) -> _Elem:
    """Associative combination of adjacent elements (ei covers the earlier
    chunk). Batched over a leading axis by associative_scan."""
    n = ei.A.shape[-1]
    I = jnp.eye(n, dtype=ei.A.dtype)
    # (I + C_i J_j) is reused in every line; one factorization each.
    M1 = I + ei.C @ ej.J                     # acts on "x_j side" quantities
    M2 = I + ej.J @ ei.C                     # transpose-side counterpart
    sol1 = jnp.linalg.solve(M1, jnp.concatenate(
        [ei.A, (ei.b + (ei.C @ ej.eta[..., None])[..., 0])[..., None],
         ei.C], axis=-1))
    s_A = sol1[..., :n]
    s_b = sol1[..., n]
    s_C = sol1[..., n + 1:]
    sol2 = jnp.linalg.solve(M2, jnp.concatenate(
        [(ej.eta - (ej.J @ ei.b[..., None])[..., 0])[..., None],
         ej.J @ ei.A], axis=-1))
    s_eta = sol2[..., 0]
    s_JA = sol2[..., 1:]
    return _Elem(
        A=ej.A @ s_A,
        b=(ej.A @ s_b[..., None])[..., 0] + ej.b,
        C=ej.A @ s_C @ jnp.swapaxes(ej.A, -1, -2) + ej.C,
        eta=(jnp.swapaxes(ei.A, -1, -2) @ s_eta[..., None])[..., 0] + ei.eta,
        J=jnp.swapaxes(ei.A, -1, -2) @ s_JA + ei.J,
    )


@pinned_precision
def lqt_solve_parallel(x0, A, B, c, Q, q, R, r, QN, qN, P=None):
    """O(log N)-depth LQT solve via ``jax.lax.associative_scan``.

    Same interface/returns as :func:`lqt_solve_sequential`; the two agree to
    f32 roundoff (tests/test_lqr.py gates them against each other and a
    dense KKT oracle).
    """
    N, n = A.shape[0], A.shape[1]
    if P is None:
        P = jnp.zeros((N, R.shape[1], n), A.dtype)
    A_t, c_t, Q_t, q_t, Rinv_P, Rinv_r = jax.vmap(_eliminate_cross_terms)(
        A, B, c, Q, q, R, r, P)

    # Per-step elements: chunk [k, k+1) carries stage cost k. Stage cost
    # 1/2 x'Qx + q'x maps to (J = Q, eta = -q); the control span is
    # C = B R^{-1} B'.
    BRinvBt = jax.vmap(lambda Bk, Rk: Bk @ jnp.linalg.solve(Rk, Bk.T))(B, R)
    elems = _Elem(A=A_t, b=c_t, C=BRinvBt, eta=-q_t, J=Q_t)
    # Terminal element (no dynamics past N).
    zero_n = jnp.zeros((1, n, n), A.dtype)
    term = _Elem(A=zero_n, b=jnp.zeros((1, n), A.dtype), C=zero_n,
                 eta=-qN[None], J=QN[None])
    elems = _Elem(*[jnp.concatenate([a, b], axis=0)
                    for a, b in zip(elems, term)])

    # Suffix products: reverse the sequence, flip the combination order.
    rev = jax.tree_util.tree_map(lambda x: jnp.flip(x, axis=0), elems)
    suffix_rev = jax.lax.associative_scan(
        lambda a, b: _combine(b, a), rev, axis=0)
    suffix = jax.tree_util.tree_map(lambda x: jnp.flip(x, axis=0), suffix_rev)
    Ss = 0.5 * (suffix.J + jnp.swapaxes(suffix.J, -1, -2))  # (N+1, n, n)
    vs = suffix.eta                                          # (N+1, n)

    # Gains from the next-step value functions — all stages in parallel.
    Ks, kffs = jax.vmap(_gains)(Ss[1:], vs[1:], A_t, B, c_t, R)

    # Forward pass: x_{k+1} = (A - B K) x_k + (c - B kff) — composition of
    # affine maps, associative.
    Acl = A_t - jnp.einsum("kij,kjl->kil", B, Ks)
    bcl = c_t - jnp.einsum("kij,kj->ki", B, kffs)

    def comb_affine(f1, f2):
        F1, f1b = f1
        F2, f2b = f2
        return F2 @ F1, (F2 @ f1b[..., None])[..., 0] + f2b

    Fs, fs = jax.lax.associative_scan(comb_affine, (Acl, bcl), axis=0)
    xs_tail = jnp.einsum("kij,j->ki", Fs, x0) + fs
    xs = jnp.concatenate([x0[None], xs_tail], axis=0)
    u_t = -jnp.einsum("kij,kj->ki", Ks, xs[:-1]) - kffs
    us = u_t - jnp.einsum("kij,kj->ki", Rinv_P, xs[:-1]) - Rinv_r
    return LqtSolution(xs=xs, us=us, Ks=Ks, kffs=kffs, Ss=Ss, vs=vs,
                       Ko=Ks + Rinv_P, ko=kffs + Rinv_r)

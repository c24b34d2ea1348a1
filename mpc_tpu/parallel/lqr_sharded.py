"""Horizon-sharded parallel-scan Riccati: LQT across a device-mesh axis.

``solver/lqr.py``'s associative-scan Riccati is O(log N) *depth* but runs on
one device. This module shards the two associative scans (the backward
value-element scan and the forward affine-rollout scan) across a ``horizon``
mesh axis — the cross-device half of SURVEY.md §2.19 (parallel-scan Riccati
reduced via collectives along a `horizon` mesh axis) and the §5
long-context row. The reference has no counterpart: its rollout is a
sequential CasADi ``mapaccum`` chain (reference: car_dynamics.py:159-166).

Blocked associative scan (the classic three-phase scheme):
  1. each device runs a *local* ``lax.associative_scan`` over its chunk;
  2. one ``all_gather`` of the per-device chunk products (tiny: one element
     per device) + a log(P)-depth scan over them yields each device's
     cross-chunk carry — this is the only cross-device traffic;
  3. one vectorized combine folds the carry into the local results.

Per-stage math (tilde transforms, element construction, gains) is
embarrassingly parallel and needs no collectives; only the scans talk.

Everything is batched: stage arrays are (B, N, ...) exactly like
``jax.vmap(lqt_solve_parallel)`` would take, with B shardable over the
``scenario`` mesh axis and N over ``horizon``.
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as PS

from mpc_tpu.parallel.mesh import HORIZON_AXIS, SCENARIO_AXIS
from mpc_tpu.solver.lqr import (LqtSolution, _Elem, _combine,
                                _eliminate_cross_terms, _gains)
from mpc_tpu.solver.precision import pinned_precision


def _flip0(tree):
    return jax.tree_util.tree_map(lambda x: jnp.flip(x, axis=0), tree)


def _identity_elem_like(e: _Elem) -> _Elem:
    """Identity of ``_combine`` for one (batched) element: (A=I, rest 0)."""
    bshape = e.A.shape[1:]           # (B_local, n, n)
    n = bshape[-1]
    I = jnp.broadcast_to(jnp.eye(n, dtype=e.A.dtype), bshape)
    Z = jnp.zeros(bshape, e.A.dtype)
    z = jnp.zeros(bshape[:-1], e.A.dtype)
    return _Elem(A=I, b=z, C=Z, eta=z, J=Z)


def _blocked_suffix_scan(combine, elems, axis_name: str, n_shards: int):
    """out[k] = elems[k] ⊗ ... ⊗ elems[-1] globally, elems sharded on axis 0.

    Runs inside shard_map; ``elems`` is the local chunk (stage-major)."""
    # phase 1: local suffix scan
    local = _flip0(lax.associative_scan(
        lambda a, b: combine(b, a), _flip0(elems), axis=0))
    # phase 2: chunk products -> cross-chunk carries
    T = jax.tree_util.tree_map(lambda x: x[0], local)
    T_all = jax.tree_util.tree_map(
        lambda x: lax.all_gather(x, axis_name), T)        # (P, ...)
    U = _flip0(lax.associative_scan(
        lambda a, b: combine(b, a), _flip0(T_all), axis=0))
    d = lax.axis_index(axis_name)
    nxt = jnp.minimum(d + 1, n_shards - 1)
    carry = jax.tree_util.tree_map(lambda u: u[nxt], U)
    ident = _identity_elem_like(elems)
    is_last = d == n_shards - 1
    carry = jax.tree_util.tree_map(
        lambda c, i: jnp.where(is_last, i, c), carry, ident)
    # phase 3: fold the carry in
    return combine(local, jax.tree_util.tree_map(lambda x: x[None], carry))


def _blocked_prefix_scan(combine, elems, identity, axis_name: str,
                         n_shards: int):
    """out[k] = elems[0] ∘ ... ∘ elems[k] globally (combine(f1, f2) =
    'apply f1 then f2'), elems sharded on axis 0."""
    local = lax.associative_scan(combine, elems, axis=0)
    T = jax.tree_util.tree_map(lambda x: x[-1], local)
    T_all = jax.tree_util.tree_map(
        lambda x: lax.all_gather(x, axis_name), T)
    V = lax.associative_scan(combine, T_all, axis=0)
    d = lax.axis_index(axis_name)
    prv = jnp.maximum(d - 1, 0)
    carry = jax.tree_util.tree_map(lambda v: v[prv], V)
    carry = jax.tree_util.tree_map(
        lambda c, i: jnp.where(d == 0, i, c), carry, identity)
    return combine(jax.tree_util.tree_map(lambda x: x[None], carry), local)


def _affine_identity_like(F):
    bshape = F.shape[1:]
    n = bshape[-1]
    I = jnp.broadcast_to(jnp.eye(n, dtype=F.dtype), bshape)
    return I, jnp.zeros(bshape[:-1], F.dtype)


def _comb_affine(f1, f2):
    F1, f1b = f1
    F2, f2b = f2
    return F2 @ F1, (F2 @ f1b[..., None])[..., 0] + f2b


def make_lqt_horizon_sharded(mesh: Mesh, horizon_axis: str = HORIZON_AXIS,
                             scenario_axis: Optional[str] = SCENARIO_AXIS):
    """Build ``solve(x0, A, B, c, Q, q, R, r, QN, qN, P=None) -> LqtSolution``
    with the Riccati scans sharded over ``horizon_axis``.

    Batched interface, identical semantics to
    ``jax.vmap(solver.lqr.lqt_solve_parallel)``: ``x0`` (B, n); stage arrays
    (B, N, ...); terminal (n, n)/(n,). B shards over ``scenario_axis``
    (pass None to replicate the batch), stages over ``horizon_axis``;
    neither B nor N needs to divide the axis sizes (identity-element
    padding). Returns batch-major LqtSolution. Caller jits.
    """
    Ph = mesh.shape[horizon_axis]
    spec = PS(horizon_axis, scenario_axis)

    def solve(x0, A, B, c, Q, q, R, r, QN, qN, P=None):
        Bb, N, n = A.shape[0], A.shape[1], A.shape[2]
        m = R.shape[-1]
        dtype = A.dtype
        if P is None:
            P = jnp.zeros((Bb, N, m, n), dtype)

        elim = jax.vmap(jax.vmap(_eliminate_cross_terms))
        A_t, c_t, Q_t, q_t, Rinv_P, Rinv_r = elim(A, B, c, Q, q, R, r, P)
        BRinvBt = jax.vmap(jax.vmap(
            lambda Bk, Rk: Bk @ jnp.linalg.solve(Rk, Bk.T)))(B, R)

        sw = lambda x: jnp.swapaxes(x, 0, 1)      # batch-major <-> stage-major

        # stage elements + terminal, stage-major (N+1, B, ...)
        elems = _Elem(A=sw(A_t), b=sw(c_t), C=sw(BRinvBt),
                      eta=-sw(q_t), J=sw(Q_t))
        term = _Elem(
            A=jnp.zeros((1, Bb, n, n), dtype),
            b=jnp.zeros((1, Bb, n), dtype),
            C=jnp.zeros((1, Bb, n, n), dtype),
            eta=jnp.broadcast_to(-qN, (1, Bb, n)).astype(dtype),
            J=jnp.broadcast_to(QN, (1, Bb, n, n)).astype(dtype))
        elems = _Elem(*[jnp.concatenate([a, b], axis=0)
                        for a, b in zip(elems, term)])

        # pad the element sequence to a multiple of Ph with identities
        # (appended AFTER the terminal element: suffix products are
        # unchanged since e ⊗ id = e)
        n_e = N + 1
        n_e_pad = Ph * math.ceil(n_e / Ph)
        if n_e_pad > n_e:
            pad = n_e_pad - n_e
            I = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (pad, Bb, n, n))
            Zm = jnp.zeros((pad, Bb, n, n), dtype)
            zv = jnp.zeros((pad, Bb, n), dtype)
            ident = _Elem(A=I, b=zv, C=Zm, eta=zv, J=Zm)
            elems = _Elem(*[jnp.concatenate([a, b], axis=0)
                            for a, b in zip(elems, ident)])

        suffix = shard_map(
            lambda e: _blocked_suffix_scan(_combine, e, horizon_axis, Ph),
            mesh=mesh, in_specs=(spec,), out_specs=spec,
            check_vma=False)(elems)
        suffix = jax.tree_util.tree_map(lambda x: x[: N + 1], suffix)
        Ss = 0.5 * (suffix.J + jnp.swapaxes(suffix.J, -1, -2))  # (N+1, B, n, n)
        vs = suffix.eta

        # per-stage gains — no collectives
        Ks, kffs = jax.vmap(jax.vmap(_gains))(
            Ss[1:], vs[1:], sw(A_t), sw(B), sw(c_t), sw(R))

        # forward: closed-loop affine maps, blocked prefix scan
        Acl = sw(A_t) - sw(B) @ Ks
        bcl = sw(c_t) - (sw(B) @ kffs[..., None])[..., 0]
        n_f_pad = Ph * math.ceil(N / Ph)
        if n_f_pad > N:
            pad = n_f_pad - N
            I = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (pad, Bb, n, n))
            Acl = jnp.concatenate([Acl, I], axis=0)
            bcl = jnp.concatenate([bcl, jnp.zeros((pad, Bb, n), dtype)],
                                  axis=0)

        def fwd_local(maps):
            ident = _affine_identity_like(maps[0])
            return _blocked_prefix_scan(_comb_affine, maps, ident,
                                        horizon_axis, Ph)

        Fs, fs = shard_map(
            fwd_local, mesh=mesh, in_specs=((spec, spec),),
            out_specs=(spec, spec), check_vma=False)((Acl, bcl))
        Fs, fs = Fs[:N], fs[:N]

        xs_tail = jnp.einsum("kbij,bj->kbi", Fs, x0) + fs
        xs = jnp.concatenate([x0[None], xs_tail], axis=0)     # (N+1, B, n)
        u_t = -jnp.einsum("kbij,kbj->kbi", Ks, xs[:-1]) - kffs
        us = u_t - jnp.einsum("kbij,kbj->kbi", sw(Rinv_P), xs[:-1]) \
            - sw(Rinv_r)

        return LqtSolution(
            xs=sw(xs), us=sw(us), Ks=sw(Ks), kffs=sw(kffs),
            Ss=sw(Ss), vs=sw(vs),
            Ko=sw(Ks + sw(Rinv_P)), ko=sw(kffs + sw(Rinv_r)))

    return pinned_precision(solve)

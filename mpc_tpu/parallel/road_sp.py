"""Sequence-parallel road geometry: centerline sharded over the ``model`` axis.

For large centerlines (long Bezier roads, 10k-scenario suites) the
nearest-point search dominates the stage cost (in the reference it is an
O(size) symbolic if_else chain *per stage*, car_dynamics.py:180-192 — the hot
loop of the whole solve, SURVEY.md 3.1). Here each device holds a chunk of
the centerline, computes local distances, and the global selection uses two
collectives:

- ``ppermute`` ring halo exchange for the cross-chunk previous/next points;
- ``all_gather`` of one candidate tuple per device + replicated argmin.

Gradient note: the *selected* points are constants w.r.t. the decision
variables (piecewise-constant selection, same subgradient convention as the
reference's if_else chain), so selection keys are wrapped in stop_gradient;
gradients flow through the vehicle position only.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from mpc_tpu.ops.road import RoadErrors, wrap_to_pi


def _ring_perm(n, shift):
    return [(i, (i + shift) % n) for i in range(n)]


def find_nearest_point_sp(pos, cl_local, axis_name, size):
    """Distributed nearest-point search with OCP semantics
    (candidates 0..size-2, first minimum wins — see ops/road.py).

    Args:
      pos: (2,) vehicle position (replicated over the model axis).
      cl_local: (chunk, 2) local centerline shard.
      axis_name: mesh axis the centerline is sharded over.
      size: global centerline size (static).

    Returns:
      (nearest, previous, next) points, each (2,), replicated.
    """
    chunk = cl_local.shape[0]
    nm = size // chunk
    me = lax.axis_index(axis_name)
    offset = me * chunk
    gidx = offset + jnp.arange(chunk)

    # Halo exchange: previous device's last point, next device's first point.
    prev_halo = lax.ppermute(cl_local[-1], axis_name, _ring_perm(nm, 1))
    next_halo = lax.ppermute(cl_local[0], axis_name, _ring_perm(nm, -1))

    prev_pts = jnp.concatenate([prev_halo[None], cl_local[:-1]], axis=0)
    next_pts = jnp.concatenate([cl_local[1:], next_halo[None]], axis=0)
    # global index 0: previous clamps to the first point (car_dynamics.py:183)
    prev_pts = jnp.where((gidx == 0)[:, None], cl_local, prev_pts)

    d2 = jnp.sum((cl_local - pos) ** 2, axis=1)
    d2 = jnp.where(gidx <= size - 2, d2, jnp.inf)  # last point never selected

    li = jnp.argmin(d2)
    cand = (d2[li], gidx[li].astype(jnp.float32),
            cl_local[li], prev_pts[li], next_pts[li])

    # Gather one candidate per device; replicated global argmin with
    # first-index tie-break (matches argmin semantics).
    d2_all, gidx_all, near_all, prev_all, next_all = jax.tree_util.tree_map(
        lambda x: lax.all_gather(x, axis_name), cand)
    d2_all = lax.stop_gradient(d2_all)
    key = d2_all + gidx_all * 1e-12  # tie-break toward lower global index
    w = jnp.argmin(key)
    return near_all[w], prev_all[w], next_all[w]


def compute_errors_ocp_sp(pos, heading, cl_local, axis_name, size) -> RoadErrors:
    """Sequence-parallel version of ops.road.compute_errors_ocp (unnormalized
    cross products, car_dynamics.py:194-228)."""
    near, prev, nxt = find_nearest_point_sp(pos, cl_local, axis_name, size)
    near = lax.stop_gradient(near)
    prev = lax.stop_gradient(prev)
    nxt = lax.stop_gradient(nxt)

    v = pos - prev
    w = near - prev
    cte = v[0] * w[1] - v[1] * w[0]
    desired = jnp.arctan2(nxt[1] - near[1], nxt[0] - near[0])
    heading_error = wrap_to_pi(desired - heading)
    vn = pos - near
    wn = nxt - near
    pos_error = vn[0] * wn[1] - vn[1] * wn[0]
    return RoadErrors(cte, heading_error, pos_error)


def make_sp_errors_fn(axis_name: str, size: int):
    """Bind axis/size: returns ``errors_fn(pos, heading, cl_local)``."""
    return partial(compute_errors_ocp_sp, axis_name=axis_name, size=size)

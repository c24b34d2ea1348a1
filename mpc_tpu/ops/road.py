"""Road geometry: centerlines, nearest-point lookup, tracking errors.

JAX-native replacement for both of the reference's road-error implementations:

- numpy ``Road`` (reference: road.py:4-81) — normalized CTE/pos error, used for
  diagnostics;
- the symbolic versions on the model class (reference:
  car_dynamics.py:174-228) — *unnormalized* cross products, used inside the
  OCP stage cost.

The reference's symbolic nearest-point search is an O(size) chain of
``cs.if_else`` selections (car_dynamics.py:180-192) only because CasADi lacks
data-dependent indexing. Here the search is a single batched distance
computation + ``argmin`` — trivially parallel and vmap-able; we do NOT
replicate the scalar chain.

Parity semantics preserved exactly:
- OCP variant scans candidates ``0 .. size-2`` (the loop at
  car_dynamics.py:185 runs ``range(1, size-1)`` with index 0 as the initial
  candidate, so the last centerline point is never selected). First minimum
  wins (strict ``<``) — same as ``argmin``.
- OCP errors are unnormalized cross products (car_dynamics.py:211-227); the
  degenerate vertical-segment branch at car_dynamics.py:217-221 is guarded by
  a *structural* ``cs.is_equal`` that is always False for distinct symbols, so
  only the ``arctan2`` branch is ever traced — we implement that branch.
- Diagnostic (numpy-Road) variant normalizes by segment length (road.py:68,79)
  and uses python negative indexing for ``idx-1`` at ``idx==0`` (wraps to the
  last point, road.py:66). The reference's unclamped ``idx+1`` raises
  IndexError at the final point (road.py:71); we clamp instead — documented
  divergence (build the correct behavior, not the crash).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


def wrap_to_pi(angle):
    """Wrap angle to [-pi, pi) (reference: road.py:22-34, car_dynamics.py:168-172)."""
    return jnp.mod(angle + jnp.pi, 2.0 * jnp.pi) - jnp.pi


# ---------------------------------------------------------------------------
# Centerline generators
# ---------------------------------------------------------------------------

def straight_centerline(size: int = 100) -> jnp.ndarray:
    """Straight road: points ``[i/10 - 0.1, 0]`` (reference: main.py:13)."""
    i = jnp.arange(size, dtype=jnp.float32)
    return jnp.stack([i / 10.0 - 0.1, jnp.zeros(size, jnp.float32)], axis=1)


def circle_centerline(size: int = 100, radius: float = 5.0,
                      center=(0.0, 0.0), y_offset: float = 5.0) -> jnp.ndarray:
    """Circular road (reference: road.py:10-18, main.py:15-22)."""
    theta = jnp.linspace(0.0, 2.0 * jnp.pi, size)
    x = radius * jnp.cos(theta) + center[0]
    y = radius * jnp.sin(theta) + center[1] + y_offset
    return jnp.stack([x, y], axis=1)


# ---------------------------------------------------------------------------
# Nearest point
# ---------------------------------------------------------------------------

class NearestPoint(NamedTuple):
    index: jnp.ndarray
    nearest: jnp.ndarray
    previous: jnp.ndarray
    next: jnp.ndarray


def find_nearest_point_ocp(pos: jnp.ndarray, centerline: jnp.ndarray) -> NearestPoint:
    """Nearest centerline point with OCP semantics (car_dynamics.py:174-192).

    Candidates are indices ``0..size-2``; previous clamps to 0 at the start.
    """
    size = centerline.shape[0]
    d2 = jnp.sum((centerline[: size - 1] - pos) ** 2, axis=1)
    idx = jnp.argmin(d2)
    prev_idx = jnp.maximum(idx - 1, 0)
    return NearestPoint(idx, centerline[idx], centerline[prev_idx], centerline[idx + 1])


def find_nearest_point(pos: jnp.ndarray, centerline: jnp.ndarray):
    """Diagnostic nearest point over the full centerline (road.py:36-50)."""
    d2 = jnp.sum((centerline - pos) ** 2, axis=1)
    idx = jnp.argmin(d2)
    return idx, centerline[idx]


# ---------------------------------------------------------------------------
# Tracking errors
# ---------------------------------------------------------------------------

class RoadErrors(NamedTuple):
    cte: jnp.ndarray
    heading_error: jnp.ndarray
    pos_error: jnp.ndarray


def _cross2(a, b):
    return a[0] * b[1] - a[1] * b[0]


def compute_errors_ocp(pos: jnp.ndarray, heading: jnp.ndarray,
                       centerline: jnp.ndarray) -> RoadErrors:
    """OCP-side errors — unnormalized cross products (car_dynamics.py:194-228).

    Used inside the stage cost; differentiable through ``argmin`` via
    straight-through point selection (the selected points are constants w.r.t.
    pos in the local region, matching CasADi's if_else subgradients).
    """
    np_ = find_nearest_point_ocp(pos, centerline)
    cte = _cross2(pos - np_.previous, np_.nearest - np_.previous)
    desired = jnp.arctan2(np_.next[1] - np_.nearest[1], np_.next[0] - np_.nearest[0])
    heading_error = wrap_to_pi(desired - heading)
    pos_error = _cross2(pos - np_.nearest, np_.next - np_.nearest)
    return RoadErrors(cte, heading_error, pos_error)


def compute_errors_ocp_windowed(pos: jnp.ndarray, heading: jnp.ndarray,
                                centerline: jnp.ndarray, center_idx,
                                window: int) -> RoadErrors:
    """OCP errors with a windowed nearest-point search.

    Within one MPC solve the vehicle can only traverse a few centerline
    points (v * Ts * N), so the per-stage argmin need not scan the whole
    road (the reference's O(size) if_else chain per stage is its hot loop,
    SURVEY.md 3.1). ``center_idx`` is the index of the nearest point to the
    *initial* state, computed once per solve; the window extends mostly
    forward of it. Results are identical to :func:`compute_errors_ocp`
    whenever the true nearest point lies inside the window.
    """
    size = centerline.shape[0]
    # bias forward: 1/4 behind, 3/4 ahead of the solve's starting index
    start = jnp.clip(center_idx - window // 4, 0, size - window)
    win = jax.lax.dynamic_slice(centerline, (start, 0), (window, 2))
    gidx = start + jnp.arange(window)
    d2 = jnp.sum((win - pos) ** 2, axis=1)
    d2 = jnp.where(gidx <= size - 2, d2, jnp.inf)  # last point never selected
    idx = start + jnp.argmin(d2)

    nearest = centerline[idx]
    prev = centerline[jnp.maximum(idx - 1, 0)]
    nxt = centerline[idx + 1]

    cte = _cross2(pos - prev, nearest - prev)
    desired = jnp.arctan2(nxt[1] - nearest[1], nxt[0] - nearest[0])
    heading_error = wrap_to_pi(desired - heading)
    pos_error = _cross2(pos - nearest, nxt - nearest)
    return RoadErrors(cte, heading_error, pos_error)


def compute_errors_diagnostic(pos: jnp.ndarray, heading: jnp.ndarray,
                              centerline: jnp.ndarray) -> RoadErrors:
    """Diagnostic errors — normalized, full-range argmin (road.py:52-81)."""
    size = centerline.shape[0]
    idx, nearest = find_nearest_point(pos, centerline)
    prev_pt = centerline[jnp.mod(idx - 1, size)]          # python negative-index wrap
    next_idx = jnp.minimum(idx + 1, size - 1)             # clamped (ref crashes here)
    next_pt = centerline[next_idx]

    w = nearest - prev_pt
    cte = _cross2(pos - prev_pt, w) / jnp.linalg.norm(w)

    desired = jnp.arctan2(next_pt[1] - nearest[1], next_pt[0] - nearest[0])
    heading_error = wrap_to_pi(desired - heading)

    w_next = next_pt - nearest
    pos_error = _cross2(pos - nearest, w_next) / jnp.linalg.norm(w_next)
    return RoadErrors(cte, heading_error, pos_error)


# Batched over positions/headings, shared centerline.
compute_errors_ocp_batched = jax.vmap(compute_errors_ocp, in_axes=(0, 0, None))
compute_errors_diag_batched = jax.vmap(compute_errors_diagnostic, in_axes=(0, 0, None))


class Road:
    """Thin convenience wrapper mirroring the reference's ``Road`` class
    (road.py:4-20): default centerline = 100-point circle of radius 5 centered
    (0, 5)."""

    def __init__(self, center=None):
        if center is None:
            self.centerline = circle_centerline()
        else:
            self.centerline = jnp.asarray(center, dtype=jnp.float32)

    def find_nearest_point(self, vehicle_position):
        return find_nearest_point(jnp.asarray(vehicle_position), self.centerline)

    def compute_errors(self, vehicle_position, vehicle_heading):
        return compute_errors_diagnostic(
            jnp.asarray(vehicle_position), jnp.asarray(vehicle_heading), self.centerline)

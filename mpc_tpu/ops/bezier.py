"""Quintic Bezier lane-change path generation.

JAX-native re-design of the reference's Bezier module
(reference: bezier_curves.py:1-66, duplicated verbatim at game_theory.py:8-18
and game_theory.py:92-113). The reference evaluates the curve point-by-point
in a Python loop over the 6 Bernstein terms; here evaluation is a single
einsum over a precomputed Bernstein basis matrix — one matmul
for any number of samples and any batch of control-point sets.

Geometry of the lane-change envelope (reference: bezier_curves.py:5-12,28-48):
lane width h=3.75, car L=4.2 / W=1.8, max heading theta=3.2 deg, l=3, Lf=1,
speeds v0=20 / v1=10, initial gap D1=50.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Default lane-change constants (reference: bezier_curves.py:5-12).
H_LANE = 3.75
CAR_L, CAR_W = 4.2, 1.8
THETA_MAX = 3.2 / 180.0 * jnp.pi
SEG_L = 3.0
LF = 1.0
V0, V1 = 20.0, 10.0
D1 = 50.0

# Binomial coefficients C(5, i) for the quintic Bernstein basis.
_BINOM5 = jnp.asarray([1.0, 5.0, 10.0, 10.0, 5.0, 1.0])


def bernstein_basis(t: jnp.ndarray, degree: int = 5) -> jnp.ndarray:
    """Bernstein basis matrix B[k, i] = C(n,i) (1-t_k)^(n-i) t_k^i, shape (T, n+1)."""
    i = jnp.arange(degree + 1, dtype=t.dtype)
    t = t[:, None]
    return _BINOM5 * (1.0 - t) ** (degree - i) * t ** i


def bezier_curve(t: jnp.ndarray, control_points: jnp.ndarray) -> jnp.ndarray:
    """Evaluate a quintic Bezier at parameters ``t``.

    Args:
      t: (T,) parameters in [0, 1].
      control_points: (2, 6) control points (reference layout:
        bezier_curves.py:40-48) or batched (..., 2, 6).

    Returns:
      (..., T, 2) curve points.
    """
    basis = bernstein_basis(jnp.asarray(t))                  # (T, 6)
    return jnp.einsum("ti,...ci->...tc", basis, control_points)


class LaneChangePath(NamedTuple):
    control_points: jnp.ndarray   # (2, 6)
    tca: jnp.ndarray              # time to collision avoidance


def lane_change_control_points(i, h: float = H_LANE, l: float = SEG_L,
                               lf: float = LF, w: float = CAR_W,
                               theta: float = THETA_MAX, v0: float = V0,
                               v1: float = V1, d1: float = D1) -> LaneChangePath:
    """Control points for the i-th member of the lane-change family
    (reference: bezier_curves.py:28-48). ``i`` may be a traced scalar or a
    batched array — the whole family evaluates in one vmap."""
    i = jnp.asarray(i, dtype=jnp.float32)
    li = lf + l
    di = li * jnp.cos(jnp.arctan2(w, 2.0 * lf) - theta)
    tc1 = d1 / (v0 - v1)
    px2 = v0 * tc1 - di
    px5 = 2.0 * px2
    px1 = px2 / i
    px4 = px5 - (px5 - px2) / i

    px = jnp.stack([jnp.zeros_like(i), px1, px2, px2, px4, px5])
    py = jnp.stack([jnp.zeros_like(i)] * 3 + [jnp.full_like(i, h)] * 3)
    tca = px2 / (v0 - v1)
    return LaneChangePath(jnp.stack([px, py]), tca)


def lane_change_family(n: int = 10, num_samples: int = 500):
    """All n lane-change paths at once: returns (n, T, 2) curve points and (n,) tca."""
    idx = jnp.arange(1, n + 1, dtype=jnp.float32)
    paths = jax.vmap(lane_change_control_points)(idx)
    t = jnp.linspace(0.0, 1.0, num_samples)
    curves = bezier_curve(t, paths.control_points)
    return curves, paths.tca


def bezier_centerline(control_points: jnp.ndarray, size: int = 100) -> jnp.ndarray:
    """Sample a Bezier path as an MPC road centerline (size, 2)."""
    t = jnp.linspace(0.0, 1.0, size)
    return bezier_curve(t, control_points)

"""Hanging-chain model — the second workload proving the solver is model-agnostic.

JAX-native re-design of the reference's hanging-chain MPC demo
(reference: alpaqa_example.py:23-141). A chain of N balls connected by
springs; the free end (ball N+1) is velocity-controlled. State layout matches
the reference (alpaqa_example.py:28-33):

  y = [y1 (d*N ball positions), y2 (d*N ball velocities), y3 (d free-end pos)]
  u = free-end velocity (d,)

The spring forces are computed **vectorized over balls** (the reference builds
them in a Python loop over CasADi symbols, alpaqa_example.py:52-62) — here
the per-ball loop becomes one array op over a (N+1, d) stack of segments.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from mpc_tpu.models.params import ChainParams


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static chain topology (N balls in `dim` dimensions)."""
    n_balls: int = 6
    dim: int = 2

    @property
    def state_dim(self) -> int:
        return 2 * self.dim * self.n_balls + self.dim

    @property
    def input_dim(self) -> int:
        return self.dim

    def gravity(self) -> jnp.ndarray:
        # reference: alpaqa_example.py:40
        g = [0.0, 0.0, -9.81] if self.dim == 3 else [0.0, -9.81]
        return jnp.asarray(g, dtype=jnp.float32)

    def x_end(self) -> jnp.ndarray:
        # ball N+1 reference position = e1 (reference: alpaqa_example.py:42)
        return jnp.eye(1, self.dim, 0, dtype=jnp.float32).ravel()

    def initial_state(self) -> jnp.ndarray:
        """Balls spread along x in [0, 1]; free end at e1 (alpaqa_example.py:116-127)."""
        n, d = self.n_balls, self.dim
        y1 = jnp.zeros((n, d)).at[:, 0].set(jnp.arange(1, n + 1) / (n + 1))
        y2 = jnp.zeros((n, d))
        y3 = jnp.zeros((d,)).at[0].set(1.0)
        return jnp.concatenate([y1.ravel(), y2.ravel(), y3])


def chain_dynamics(spec: ChainSpec):
    """Build the continuous-time ODE ``f(y, u, p) -> y'`` for a chain spec.

    Matches the spring-force law of alpaqa_example.py:52-62:
      F_ab = D * (1 - L / ||xb - xa||) * (xb - xa)
      ball i accel = (F_{i,i+1} - F_{i-1,i}) / m + g
    """
    n, d = spec.n_balls, spec.dim
    g = spec.gravity()

    def f(y, u, p: ChainParams):
        y1 = y[: n * d].reshape(n, d)                # ball positions
        y2 = y[n * d: 2 * n * d].reshape(n, d)       # ball velocities
        y3 = y[2 * n * d:]                           # free-end position

        # Segment endpoints: anchor(0) -> ball_1 -> ... -> ball_N -> free end.
        pts = jnp.concatenate([jnp.zeros((1, d)), y1, y3[None, :]], axis=0)  # (N+2, d)
        seg = pts[1:] - pts[:-1]                                             # (N+1, d)
        dist = jnp.linalg.norm(seg, axis=1, keepdims=True)
        force = p.D * (1.0 - p.L / dist) * seg                               # (N+1, d)

        accel = (force[1:] - force[:-1]) / p.m + g                           # (N, d)
        return jnp.concatenate([y2.ravel(), accel.ravel(), jnp.asarray(u)])

    return f


def chain_state_to_pos(spec: ChainSpec, y: jnp.ndarray):
    """Positions including the fixed anchor, for plotting
    (reference: alpaqa_example.py:82-90)."""
    n, d = spec.n_balls, spec.dim
    y1 = y[: n * d].reshape(n, d)
    y3 = y[2 * n * d:]
    pts = jnp.concatenate([jnp.zeros((1, d)), y1, y3[None, :]], axis=0)
    if d == 2:
        return pts[:, 0], pts[:, 1], jnp.zeros(n + 2)
    return pts[:, 0], pts[:, 1], pts[:, 2]

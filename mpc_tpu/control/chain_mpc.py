"""Hanging-chain MPC: OCP assembly and controller.

JAX-native re-design of the reference's hanging-chain MPC demo
(reference: alpaqa_example.py:169-232): quadratic tracking cost, cubic ground
constraint per ball per stage with a *bounded* D (alpaqa_example.py:212 —
unlike the vehicle OCP this exercises the full ALM multiplier loop), input
box |u| <= 1, ALM eps=1e-4 / delta=1e-4 / Sigma_0=1e5
(alpaqa_example.py:217-232).

Constraint family (alpaqa_example.py:190-204): with g_c(c, x) = c0 x^3 +
c1 x^2 + c2 x, each ball's height must satisfy y - g_c(c, x) >= lb where the
coefficients encode the cubic floor c(x-a)^3 + d(x-a) + b.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import MpcController
from mpc_tpu.models.chain import ChainSpec, chain_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import ChainParams
from mpc_tpu.ops.costs import chain_stage_cost
from mpc_tpu.solver.alm import make_alm_solver
from mpc_tpu.solver.problem import Box, Problem, build_ocp_problem

# Cubic floor c(x-a)^3 + d(x-a) + b (reference: alpaqa_example.py:202-204).
FLOOR_A, FLOOR_B, FLOOR_C, FLOOR_D = 0.6, -1.4, 5.0, 2.2


def floor_coefficients(a: float = FLOOR_A, c: float = FLOOR_C,
                       d: float = FLOOR_D):
    """Expand c(x-a)^3 + d(x-a) + b into monomial coefficients [c0, c1, c2]
    and the constraint lower bound (alpaqa_example.py:203-204)."""
    coeff = jnp.asarray([c, -3.0 * a * c, 3.0 * a * a * c + d], jnp.float32)
    lb = FLOOR_B - c * a ** 3 - d * a
    return coeff, lb


def g_constr(coeff, x):
    """Cubic constraint polynomial (alpaqa_example.py:190)."""
    return coeff[0] * x ** 3 + coeff[1] * x ** 2 + coeff[2] * x


def build_chain_ocp(spec: ChainSpec = ChainSpec(), n_horiz: int = 12,
                    ts: float = 0.05) -> Problem:
    """Chain OCP: n = dim*N_horiz decision vars, m = (N+1)*N_horiz
    constraints with D = [floor_lb, inf)."""
    f_d = discretize(chain_dynamics(spec), ts=ts)
    n, d = spec.n_balls, spec.dim
    x_end = spec.x_end()

    def stage_cost(y, u, param):
        return chain_stage_cost(y, u, n, d, x_end)

    def stage_constraints(y, u, param):
        coeff = param["constr"]
        y1 = y[: n * d].reshape(n, d)
        ball_c = y1[:, d - 1] - g_constr(coeff, y1[:, 0])
        free_end = y[-1] - g_constr(coeff, y[2 * n * d])
        return jnp.concatenate([ball_c, free_end[None]])

    m = (n + 1) * n_horiz
    _, lb = floor_coefficients()
    C = Box(-jnp.ones(d * n_horiz), jnp.ones(d * n_horiz))
    D = Box(jnp.full((m,), lb, jnp.float32), jnp.full((m,), jnp.inf))

    return build_ocp_problem(f_d, stage_cost, n_horiz, spec.state_dim, d, C,
                             stage_constraints, n + 1, D)


def build_chain_controller(spec: ChainSpec = ChainSpec(), n_horiz: int = 12,
                           ts: float = 0.05,
                           alm_cfg: Optional[AlmConfig] = None,
                           panoc_cfg: Optional[PanocConfig] = None
                           ) -> MpcController:
    """Chain MPC controller (reference solver config at
    alpaqa_example.py:217-232; warm start U = 0, alpaqa_example.py:241)."""
    problem = build_chain_ocp(spec, n_horiz, ts)
    if alm_cfg is None:
        # reference: eps=1e-4, delta=1e-4, Sigma_0=1e5
        alm_cfg = AlmConfig(eps=1e-4, delta=1e-4, sigma_0=1e5, max_iter=12,
                            eps_0=1e-2)
    if panoc_cfg is None:
        panoc_cfg = PanocConfig(lbfgs_memory=n_horiz, max_iter=250)
    solve = make_alm_solver(problem, alm_cfg, panoc_cfg)
    return MpcController(problem=problem, solve=solve, n_horiz=n_horiz,
                         input_dim=spec.dim,
                         warm_start_input=(0.0,) * spec.dim,
                         sigma_0=alm_cfg.sigma_0)

"""Sharded batched MPC solves over a (scenario, model) device mesh.

The JAX-native replacement for everything the reference *lacks*
(SURVEY.md 2.19): scenario data parallelism via ``shard_map`` over the
``scenario`` axis and sequence parallelism over the ``model`` axis for the
road-geometry search. Collectives (ppermute/all_gather) run over the
devices' links; multi-host runs join through jax.distributed with the same
code.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_ocp
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.costs import DEFAULT_VEHICLE_WEIGHTS
from mpc_tpu.parallel.mesh import MODEL_AXIS, SCENARIO_AXIS
from mpc_tpu.parallel.road_sp import make_sp_errors_fn
from mpc_tpu.solver.alm import make_alm_solver


def make_sharded_vehicle_solver(mesh: Mesh, n_horiz: int = 12,
                                centerline_size: int = 100,
                                v_ref: float = 1.0, ts: float = 0.05,
                                weights=DEFAULT_VEHICLE_WEIGHTS,
                                alm_cfg: Optional[AlmConfig] = None,
                                panoc_cfg: Optional[PanocConfig] = None,
                                unroll: Optional[int] = None):
    """Build a jitted sharded batch solver.

    Returns ``solve_batch(y0s, centerline, params, U0s, lam0s)`` where
    - ``y0s``: (B, 6) initial states, sharded over ``scenario``;
    - ``centerline``: (size, 2), sharded over ``model``;
    - ``U0s``: (B, 2*N) warm starts, sharded over ``scenario``;
    - ``lam0s``: (B, m) multipliers, sharded over ``scenario``.

    Output: per-scenario optimal U, multipliers, convergence mask, iteration
    counts — sharded like the inputs. B must divide by the scenario-axis
    size; ``centerline_size`` by the model-axis size. ``unroll`` is the
    rollout scan's unroll factor (``build_vehicle_ocp``).
    """
    if alm_cfg is None:
        alm_cfg = AlmConfig(eps=1e-5)
    if panoc_cfg is None:
        panoc_cfg = PanocConfig(lbfgs_memory=n_horiz, max_iter=300)

    n_model = mesh.shape[MODEL_AXIS]
    if n_model > 1:
        errors_fn = make_sp_errors_fn(MODEL_AXIS, centerline_size)
    else:
        errors_fn = None

    problem = build_vehicle_ocp(n_horiz, centerline_size, v_ref, ts,
                                weights=weights, errors_fn=errors_fn,
                                unroll=unroll)
    solve = make_alm_solver(problem, alm_cfg, panoc_cfg)

    def shard_fn(y0s, cl_local, params, U0s, lam0s):
        # y0s/U0s/lam0s: local scenario shard; cl_local: local model chunk.
        def one(y0, U0, lam0):
            res = solve({"y0": y0, "p": params, "centerline": cl_local},
                        U0, lam0)
            return res.u, res.lam, res.converged, res.inner_iterations

        return jax.vmap(one)(y0s, U0s, lam0s)

    mapped = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(SCENARIO_AXIS), P(MODEL_AXIS, None), P(),
                  P(SCENARIO_AXIS), P(SCENARIO_AXIS)),
        out_specs=(P(SCENARIO_AXIS), P(SCENARIO_AXIS), P(SCENARIO_AXIS),
                   P(SCENARIO_AXIS)),
        check_vma=False,
    )
    return jax.jit(mapped)


def make_sharded_closed_loop(mesh: Mesh, n_sim: int, n_horiz: int = 12,
                             centerline_size: int = 100, v_ref: float = 1.0,
                             ts: float = 0.05,
                             weights=DEFAULT_VEHICLE_WEIGHTS,
                             alm_cfg: Optional[AlmConfig] = None,
                             panoc_cfg: Optional[PanocConfig] = None):
    """Full closed loop (solver + plant scan) sharded over scenarios.

    This is the 'training step' analogue of the framework: per step it runs a
    warm-started batched trajectory optimization and advances every plant —
    all inside one compiled, mesh-sharded program.
    """
    from mpc_tpu.models.bicycle import pacejka_dynamics
    from mpc_tpu.models.integrators import discretize

    if alm_cfg is None:
        alm_cfg = AlmConfig(eps=1e-5)
    if panoc_cfg is None:
        panoc_cfg = PanocConfig(lbfgs_memory=n_horiz, max_iter=300)

    n_model = mesh.shape[MODEL_AXIS]
    errors_fn = (make_sp_errors_fn(MODEL_AXIS, centerline_size)
                 if n_model > 1 else None)

    problem = build_vehicle_ocp(n_horiz, centerline_size, v_ref, ts,
                                weights=weights, errors_fn=errors_fn)
    solve = make_alm_solver(problem, alm_cfg, panoc_cfg)
    f_d = discretize(pacejka_dynamics, ts=ts)

    def shard_fn(y0s, cl_local, params):
        b_local = y0s.shape[0]
        U0 = jnp.tile(jnp.asarray([1.0, 0.0], y0s.dtype), n_horiz)
        U0s = jnp.tile(U0, (b_local, 1))
        lam0s = jnp.zeros((b_local, problem.m), y0s.dtype)

        def step(carry, _):
            ys, Us, lams = carry

            def one(y, U, lam):
                res = solve({"y0": y, "p": params, "centerline": cl_local},
                            U, lam)
                u0 = res.u[:2]
                y_next = f_d(y, u0, params)
                return y_next, res.u, res.lam, res.converged
            ys2, Us2, lams2, conv = jax.vmap(one)(ys, Us, lams)
            return (ys2, Us2, lams2), (ys2, conv)

        (ys, _, _), (traj, conv) = jax.lax.scan(
            step, (y0s, U0s, lam0s), None, length=n_sim)
        return ys, traj, conv

    mapped = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(SCENARIO_AXIS), P(MODEL_AXIS, None), P()),
        out_specs=(P(SCENARIO_AXIS), P(None, SCENARIO_AXIS),
                   P(None, SCENARIO_AXIS)),
        check_vma=False,
    )
    return jax.jit(mapped)

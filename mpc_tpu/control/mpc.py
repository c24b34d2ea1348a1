"""Warm-started MPC controllers.

JAX-native equivalent of the reference's ``MPCController``
(reference: controller.py:10-69) and the vehicle OCP assembly
(reference: main.py:25-59). The controller is *functional*: its carried state
(warm-start inputs U and multipliers lam, plus iteration/failure counters —
controller.py:20-21,63-64) is an explicit pytree threaded through ``step``,
so closed loops run under ``lax.scan``, batch under ``vmap``, and shard under
``shard_map`` without mutation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from mpc_tpu.config import AlmConfig, MpcConfig, PanocConfig
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.costs import DEFAULT_VEHICLE_WEIGHTS, vehicle_stage_cost
from mpc_tpu.solver.alm import AlmResult, make_alm_solver
from mpc_tpu.solver.problem import Box, Problem, build_ocp_problem

# Quadratic state-constraint offsets: y_i^2 - b_i per stage
# (reference: main.py:43-52).
STATE_CONSTRAINT_OFFSETS = (20.0, 1.0, 1.0, 2.0, 1.0, 0.1)


class MpcCarry(NamedTuple):
    """Warm-start carry across MPC steps (reference: controller.py:20-21,57).

    Beyond the reference's (U, lam) warm start, the ALM penalties ``sigma``
    are carried too: in MPC steady state the active set barely changes
    between steps, so re-learning the penalties (and re-running the eps
    homotopy) every step is pure waste — a warm solve needs ~1 outer
    iteration instead of the full schedule. ``sigma = 0`` is the *cold*
    sentinel: the first solve of a rollout runs the full eps_0 -> eps
    homotopy from sigma_0 (alpaqa's cold-start behavior); the solver caps
    carried penalties at sigma_0 so they cannot ratchet up across a rollout
    (see solver/alm.py).
    """
    U: jnp.ndarray          # (n_horiz * input_dim,) flat input sequence
    lam: jnp.ndarray        # (m,) Lagrange multipliers
    sigma: jnp.ndarray      # (m,) ALM penalties
    gamma: jnp.ndarray      # () PANOC step size (<=0 -> re-estimate)
    tot_it: jnp.ndarray     # accumulated inner iterations (controller.py:63)
    failures: jnp.ndarray   # accumulated non-Converged solves (controller.py:64)


class MpcStepOut(NamedTuple):
    carry: MpcCarry
    u0: jnp.ndarray         # first optimal input (applied to the plant)
    result: AlmResult       # full solver stats for observability


@dataclasses.dataclass(frozen=True)
class MpcController:
    """A built MPC controller: jit/vmap-able ``step`` + initial carry."""
    problem: Problem
    solve: Callable                    # (param, U0, lam0, sigma0) -> AlmResult
    n_horiz: int
    input_dim: int
    warm_start_input: tuple            # repeated per stage for the initial U
    sigma_0: float = 1e5               # initial ALM penalty for the carry
    # NOTE on warm-start shifting (the standard RTI/MPC trick of rotating
    # the previous plan by one stage): measured and NOT shipped — on the
    # straight road it costs ~20% more PANOC iterations, on the circle it
    # saves ~11% but introduces convergence failures
    # (examples/exp_shift_warm.py), because the
    # carried gamma corresponds to the unshifted point and the re-estimate
    # costs more than the shifted guess saves. A caller who wants it anyway
    # can pass the rotation as ``warm_prep``; the reference reuses U
    # verbatim (controller.py:57).
    #
    # Decision vectors larger than the input sequence (multiple shooting:
    # z = [U; X_1..X_{M-1}]) are supported via ``n_extra`` tail entries
    # (zero-initialized) and ``warm_prep``, a traced hook
    # ``(z, param, cold) -> z`` applied before each solve — e.g. rolling
    # the input sequence out to seed feasible segment-start states on cold
    # lanes (solver/multiple_shooting.py:ms_warm_start).
    n_extra: int = 0
    warm_prep: Optional[Callable] = None

    def init_carry(self, dtype=jnp.float32) -> MpcCarry:
        U0 = jnp.tile(jnp.asarray(self.warm_start_input, dtype), self.n_horiz)
        if self.n_extra:
            U0 = jnp.concatenate([U0, jnp.zeros((self.n_extra,), dtype)])
        return MpcCarry(
            U=U0,
            lam=jnp.zeros((self.problem.m,), dtype),
            sigma=jnp.zeros((self.problem.m,), dtype),  # 0 -> cold start
            gamma=jnp.zeros((), dtype),   # 0 -> fresh Lipschitz estimate
            tot_it=jnp.zeros((), jnp.int32),
            failures=jnp.zeros((), jnp.int32),
        )

    def step(self, carry: MpcCarry, param: Any) -> MpcStepOut:
        """One MPC solve with warm start (reference: controller.py:51-69).

        ``param`` is the per-step parameter pytree (initial state ``y0``,
        model params ``p``, road, ...). Returns the updated warm-start carry,
        the first input of the optimal sequence (main.py:140-141), and stats.
        """
        U0, lam0, sigma0 = carry.U, carry.lam, carry.sigma
        if self.warm_prep is not None:
            # cold = the ALM cold-start sentinel (sigma == 0, init_carry)
            cold = jnp.all(sigma0 <= 0)
            U0 = self.warm_prep(U0, param, cold)
        res = self.solve(param, U0, lam0, sigma0=sigma0, gamma0=carry.gamma)
        # Failure recovery: a non-converged solve leaves sigma/gamma in
        # whatever corner it diverged into — carrying them forward compounds
        # the failure across the rollout. Reset those lanes to the cold
        # sentinel so the next solve re-runs the full homotopy (the batched
        # analogue of the reference restarting its solver by hand).
        ok = res.converged
        new_carry = MpcCarry(
            U=res.u,
            lam=res.lam,
            sigma=jnp.where(ok, res.sigma, jnp.zeros_like(res.sigma)),
            gamma=jnp.where(ok, res.gamma, jnp.zeros_like(res.gamma)),
            tot_it=carry.tot_it + res.inner_iterations,
            failures=carry.failures + (~res.converged).astype(jnp.int32),
        )
        u0 = res.u[: self.input_dim]
        return MpcStepOut(new_carry, u0, res)


def input_to_matrix(u_flat: jnp.ndarray, input_dim: int = 2) -> jnp.ndarray:
    """Flat input vector -> (input_dim, N) matrix, stage-major.

    The reference stores U stage-major (CasADi column-major F-order reshape,
    car_dynamics.py:149-157): flat layout ``[d0, delta0, d1, delta1, ...]``.
    """
    return u_flat.reshape(-1, input_dim).T


def build_vehicle_ocp(n_horiz: int = 12, centerline_size: int = 100,
                      v_ref: float = 1.0, ts: float = 0.05,
                      params: Optional[VehicleParams] = None,
                      weights=DEFAULT_VEHICLE_WEIGHTS,
                      bound_state_constraints: bool = False,
                      errors_fn=None, window: Optional[int] = None,
                      model: str = "pacejka",
                      unroll: Optional[int] = None,
                      obstacle_weight: float = 0.0,
                      obstacle_field_kwargs: Optional[dict] = None) -> Problem:
    """Vehicle OCP matching reference main.py:25-59.

    Decision variable: flat input sequence (2*N,). Parameters: pytree
    ``{"y0": (6,), "p": VehicleParams, "centerline": (size, 2)}`` — the
    structured analogue of the flat ``[y_init; centerline; params]`` vector
    (main.py:27-30). Stage cost from car_dynamics.py:230-258; quadratic state
    constraints from main.py:43-52. The reference leaves the D bounds
    commented out (main.py:57) so they are built but unbounded by default;
    ``bound_state_constraints=True`` activates ``g <= 0``.

    ``obstacle_weight > 0`` adds the differentiable obstacle risk field
    (ops/potential_field.py — the loop the reference's viz-only dpf_test.py
    never closed) to every stage cost; the parameter pytree then also
    carries ``obstacles`` (K, 4) rows ``[x, y, phi, v]``.
    """
    if params is None:
        params = VehicleParams()
    if model == "pacejka":
        state_dim = 6
        f_d = discretize(pacejka_dynamics, ts=ts)
    elif model == "simplified":
        # kinematic bicycle [x, y, phi, v] (config #1: kinematic model,
        # straight road, N=20) — input boxes only, no state constraints
        from mpc_tpu.models.bicycle import simplified_dynamics
        state_dim = 4
        f_d = discretize(simplified_dynamics, ts=ts)
    else:
        raise ValueError(f"unknown model {model!r}")

    param_prep = None
    if window is not None:
        # Windowed nearest-point search: anchor the window at the nearest
        # point to the initial state, computed once per cost evaluation
        # (see ops.road.compute_errors_ocp_windowed). ``window`` must cover
        # the horizon's worst-case travel in centerline points.
        from mpc_tpu.ops.road import (compute_errors_ocp_windowed,
                                      find_nearest_point)

        def param_prep(param):
            idx, _ = find_nearest_point(param["y0"][:2], param["centerline"])
            return dict(param, window_center=idx)

        def stage_cost(x, u, param):
            def werr(pos, heading, cl):
                return compute_errors_ocp_windowed(
                    pos, heading, cl, param["window_center"], window)
            return vehicle_stage_cost(x, u, param["centerline"], v_ref,
                                      weights, errors_fn=werr)
    elif errors_fn is None:
        def stage_cost(x, u, param):
            return vehicle_stage_cost(x, u, param["centerline"], v_ref, weights)
    else:
        def stage_cost(x, u, param):
            return vehicle_stage_cost(x, u, param["centerline"], v_ref, weights,
                                      errors_fn=errors_fn)

    if obstacle_weight > 0.0:
        from mpc_tpu.ops.potential_field import obstacle_stage_cost
        obs_kw = obstacle_field_kwargs or {}
        base_stage_cost = stage_cost

        def stage_cost(x, u, param):
            return base_stage_cost(x, u, param) + obstacle_stage_cost(
                x, param["obstacles"], weight=obstacle_weight, **obs_kw)

    C = Box(
        lower=jnp.tile(jnp.asarray([-params.max_drive, -params.max_steer], jnp.float32), n_horiz),
        upper=jnp.tile(jnp.asarray([params.max_drive, params.max_steer], jnp.float32), n_horiz),
    )

    if state_dim == 6:
        offs = jnp.asarray(STATE_CONSTRAINT_OFFSETS, jnp.float32)

        def stage_constraints(x, u, param):
            return x ** 2 - offs

        m = 6 * n_horiz
        n_stage = 6
    else:
        stage_constraints, m, n_stage = None, 0, 0

    if bound_state_constraints and m:
        D = Box(jnp.full((m,), -jnp.inf), jnp.zeros((m,)))
    else:
        D = Box.unbounded(m)

    problem = build_ocp_problem(
        f_d, stage_cost, n_horiz, state_dim=state_dim, input_dim=2, C=C,
        stage_constraints=stage_constraints, n_stage_constraints=n_stage, D=D,
        param_prep=param_prep, unroll=unroll)
    if obstacle_weight > 0.0:
        problem = dataclasses.replace(problem, uses_obstacles=True)

    return problem


def build_vehicle_controller(n_horiz: int = 12, centerline_size: int = 100,
                             v_ref: float = 1.0, ts: float = 0.05,
                             params: Optional[VehicleParams] = None,
                             alm_cfg: Optional[AlmConfig] = None,
                             panoc_cfg: Optional[PanocConfig] = None,
                             bound_state_constraints: bool = False,
                             window: Optional[int] = None,
                             model: str = "pacejka",
                             weights=DEFAULT_VEHICLE_WEIGHTS,
                             unroll: Optional[int] = None,
                             obstacle_weight: float = 0.0,
                             obstacle_field_kwargs: Optional[dict] = None) -> MpcController:
    """Vehicle MPC controller with the reference's solver configuration.

    Warm start ``U = tile([1, 0], N)`` (controller.py:20); L-BFGS memory =
    N_horiz (controller.py:36); eps/delta/Sigma_0 = 1e-6/1e-4/1e5
    (controller.py:41-43).
    """
    problem = build_vehicle_ocp(n_horiz, centerline_size, v_ref, ts, params,
                                weights=weights,
                                bound_state_constraints=bound_state_constraints,
                                window=window, model=model, unroll=unroll,
                                obstacle_weight=obstacle_weight,
                                obstacle_field_kwargs=obstacle_field_kwargs)
    if alm_cfg is None:
        alm_cfg = AlmConfig()
    if panoc_cfg is None:
        panoc_cfg = PanocConfig(lbfgs_memory=n_horiz)
    solve = make_alm_solver(problem, alm_cfg, panoc_cfg)
    return MpcController(problem=problem, solve=solve, n_horiz=n_horiz,
                         input_dim=2, warm_start_input=(1.0, 0.0),
                         sigma_0=alm_cfg.sigma_0)


def build_vehicle_ilqr_controller(n_horiz: int = 40, v_ref: float = 1.0,
                                  ts: float = 0.05,
                                  params: Optional[VehicleParams] = None,
                                  bound_state_constraints: bool = False,
                                  weights=DEFAULT_VEHICLE_WEIGHTS,
                                  model: str = "pacejka",
                                  alm_cfg: Optional[AlmConfig] = None,
                                  ilqr_cfg=None,
                                  obstacle_weight: float = 0.0,
                                  obstacle_field_kwargs: Optional[dict] = None,
                                  mesh=None):
    """Vehicle MPC controller backed by AL-iLQR (solver/ilqr.py).

    Second solver family next to ALM+PANOC, exploiting the OCP structure
    the reference's alpaqa solver never sees (it gets a flat NLP,
    controller.py:27-48): per-stage derivatives in one vmap, a
    parallel-scan Riccati backward pass (O(log N) sequential depth on the
    horizon — SURVEY.md §5 long-context row), and a parallel line-search
    fan forward pass. State constraints (main.py:43-52 with the D bounds
    active) go through the same ALM outer semantics as solver/alm.py, so
    ``MpcController`` drives either solver unchanged.

    ``mesh``: a ``(scenario, horizon)`` device mesh
    (parallel/mesh.py:make_horizon_mesh). When given, returns the
    *batch-native* ``BatchedMpcController`` whose Riccati backward runs
    horizon-sharded over the mesh (parallel/ilqr_sharded.py) — the
    cross-device horizon axis of SURVEY.md §2.19; carries/params then take a
    leading batch axis (divisible by the mesh's scenario axis) instead of
    being vmapped per lane.
    """
    from mpc_tpu.solver.ilqr import IlqrConfig, make_al_ilqr_solver

    if params is None:
        params = VehicleParams()
    if model == "pacejka":
        state_dim = 6
        f_d = discretize(pacejka_dynamics, ts=ts)
    elif model == "simplified":
        from mpc_tpu.models.bicycle import simplified_dynamics
        state_dim = 4
        f_d = discretize(simplified_dynamics, ts=ts)
    else:
        raise ValueError(f"unknown model {model!r}")

    def stage_cost(x, u, param):
        return vehicle_stage_cost(x, u, param["centerline"], v_ref, weights)

    # residual form (cost == sum(res**2)) enables the Gauss-Newton backward
    # pass; the obstacle field term is not a sum of squares, so the full
    # second-order path is used when it is active.
    from mpc_tpu.ops.costs import vehicle_stage_residuals

    def stage_residuals(x, u, param):
        return vehicle_stage_residuals(x, u, param["centerline"], v_ref,
                                       weights)

    if obstacle_weight > 0.0:
        from mpc_tpu.ops.potential_field import obstacle_stage_cost
        obs_kw = obstacle_field_kwargs or {}
        base_stage_cost = stage_cost
        stage_residuals = None

        def stage_cost(x, u, param):
            return base_stage_cost(x, u, param) + obstacle_stage_cost(
                x, param["obstacles"], weight=obstacle_weight, **obs_kw)

    C = Box(
        lower=jnp.tile(jnp.asarray([-params.max_drive, -params.max_steer],
                                   jnp.float32), n_horiz),
        upper=jnp.tile(jnp.asarray([params.max_drive, params.max_steer],
                                   jnp.float32), n_horiz),
    )

    stage_constraints, n_stage = None, 0
    if bound_state_constraints and state_dim == 6:
        offs = jnp.asarray(STATE_CONSTRAINT_OFFSETS, jnp.float32)

        def stage_constraints(x, u, param):
            return x ** 2 - offs

        n_stage = 6
    m = n_stage * n_horiz
    D = Box(jnp.full((m,), -jnp.inf), jnp.zeros((m,))) if m \
        else Box.unbounded(0)

    problem = build_ocp_problem(
        f_d, stage_cost, n_horiz, state_dim=state_dim, input_dim=2, C=C,
        stage_constraints=stage_constraints, n_stage_constraints=n_stage,
        D=D)
    if obstacle_weight > 0.0:
        problem = dataclasses.replace(problem, uses_obstacles=True)

    if alm_cfg is None:
        alm_cfg = AlmConfig()
    if ilqr_cfg is None:
        ilqr_cfg = IlqrConfig()
    if mesh is not None:
        from mpc_tpu.parallel.ilqr_sharded import (
            BatchedMpcController, make_al_ilqr_solver_batched)
        solve_b = make_al_ilqr_solver_batched(
            f_d, stage_cost, n_horiz, state_dim, 2, u_box=C,
            stage_constraints=stage_constraints, n_stage_constraints=n_stage,
            D=D, alm_cfg=alm_cfg, ilqr_cfg=ilqr_cfg,
            stage_residuals=stage_residuals, mesh=mesh)
        return BatchedMpcController(solve=solve_b, n_horiz=n_horiz,
                                    input_dim=2, m=m,
                                    warm_start_input=(1.0, 0.0))
    solve = make_al_ilqr_solver(
        f_d, stage_cost, n_horiz, state_dim, 2, u_box=C,
        stage_constraints=stage_constraints, n_stage_constraints=n_stage,
        D=D, alm_cfg=alm_cfg, ilqr_cfg=ilqr_cfg,
        stage_residuals=stage_residuals)
    return MpcController(problem=problem, solve=solve, n_horiz=n_horiz,
                         input_dim=2, warm_start_input=(1.0, 0.0),
                         sigma_0=alm_cfg.sigma_0)


def build_vehicle_ms_controller(n_horiz: int = 40, n_segments: int = 8,
                                v_ref: float = 1.0, ts: float = 0.05,
                                params: Optional[VehicleParams] = None,
                                alm_cfg: Optional[AlmConfig] = None,
                                panoc_cfg: Optional[PanocConfig] = None,
                                bound_state_constraints: bool = False,
                                weights=DEFAULT_VEHICLE_WEIGHTS,
                                model: str = "pacejka",
                                unroll: Optional[int] = None,
                                state_bound=None,
                                sigma_0_defect: float = 10.0):
    """Vehicle MPC controller on the multiple-shooting OCP.

    Horizon-parallel counterpart of :func:`build_vehicle_controller`
    (SURVEY.md §5 long-context row): the N-step rollout is split into
    ``n_segments`` segments rolled out in parallel (sequential depth
    N/n_segments per cost evaluation instead of N), glued by defect
    equality constraints handled by the ALM layer
    (solver/multiple_shooting.py). The reference only single-shoots
    (main.py:34-40).

    Cold lanes seed the segment-start states by rolling out the warm-start
    input sequence (``ms_warm_start``), so the first solve starts with zero
    defects; warm lanes carry the full decision vector across MPC steps.

    ``sigma_0_defect``: initial ALM penalty for the defect equalities —
    deliberately gentle (measured: large Sigma_0 makes the f32 augmented
    Lagrangian too stiff for the inner solver; see
    tests/test_multiple_shooting.py). Stage inequalities (when
    ``bound_state_constraints``) keep ``alm_cfg.sigma_0``.

    Returns ``(MpcController, MsLayout)``.
    """
    from mpc_tpu.solver.multiple_shooting import (build_ms_ocp_problem,
                                                  ms_warm_start)

    if params is None:
        params = VehicleParams()
    if model == "pacejka":
        state_dim = 6
        f_d = discretize(pacejka_dynamics, ts=ts)
    elif model == "simplified":
        from mpc_tpu.models.bicycle import simplified_dynamics
        state_dim = 4
        f_d = discretize(simplified_dynamics, ts=ts)
    else:
        raise ValueError(f"unknown model {model!r}")

    def stage_cost(x, u, param):
        return vehicle_stage_cost(x, u, param["centerline"], v_ref, weights)

    C_in = Box(
        lower=jnp.tile(jnp.asarray([-params.max_drive, -params.max_steer],
                                   jnp.float32), n_horiz),
        upper=jnp.tile(jnp.asarray([params.max_drive, params.max_steer],
                                   jnp.float32), n_horiz),
    )

    stage_constraints, n_stage, D_stage = None, 0, None
    if bound_state_constraints and state_dim == 6:
        offs = jnp.asarray(STATE_CONSTRAINT_OFFSETS, jnp.float32)

        def stage_constraints(x, u, param):
            return x ** 2 - offs

        n_stage = 6
        m_stage = n_stage * n_horiz
        D_stage = Box(jnp.full((m_stage,), -jnp.inf), jnp.zeros((m_stage,)))

    problem, lo = build_ms_ocp_problem(
        f_d, stage_cost, n_horiz, n_segments, state_dim, 2, C_in,
        stage_constraints=stage_constraints, n_stage_constraints=n_stage,
        D_stage=D_stage, unroll=unroll, state_bound=state_bound)

    if alm_cfg is None:
        alm_cfg = AlmConfig(eps=1e-4, delta=1e-4, sigma_0=1e3,
                            penalty_factor=5.0)
    if panoc_cfg is None:
        panoc_cfg = PanocConfig(lbfgs_memory=2 * n_segments + 8)
    # per-constraint initial penalties: [stage inequalities; defects]
    import numpy as np
    m_stage = n_stage * n_horiz
    sigma_0 = np.concatenate([
        np.full(m_stage, float(alm_cfg.sigma_0), np.float32),
        np.full(problem.m - m_stage, sigma_0_defect, np.float32),
    ])
    alm_cfg = dataclasses.replace(alm_cfg, sigma_0=sigma_0)
    solve = make_alm_solver(problem, alm_cfg, panoc_cfg)

    def warm_prep(z, param, cold):
        us = z[: lo.n_inputs]
        z_cold = ms_warm_start(f_d, lo, param["y0"], us, param["p"])
        return jnp.where(cold, z_cold, z)

    ctrl = MpcController(problem=problem, solve=solve, n_horiz=n_horiz,
                         input_dim=2, warm_start_input=(1.0, 0.0),
                         sigma_0=sigma_0_defect, n_extra=lo.n_states,
                         warm_prep=warm_prep)
    return ctrl, lo

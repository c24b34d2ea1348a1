"""Parity gate: our f32 solver vs an independent f64 CPU optimizer.

alpaqa is not installable in this environment, so the closed-loop parity
check (BASELINE.md: trajectory error <= 1e-3 at equal horizon) is grounded by
an *independent* float64 transcription of the exact same OCP (RK4 rollout +
unnormalized road errors + stage cost, reimplemented in plain numpy in
``mpc_tpu/utils/f64_oracle.py``) solved with scipy L-BFGS-B. The reference's
plant equals its prediction model (main.py:145), so equal-OCP equal-solution
implies equal closed loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from scipy.optimize import minimize

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_ocp
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.solver.alm import make_alm_solver
from mpc_tpu.utils.f64_oracle import (COST_TOL, N_HORIZ,
                                      PARITY_INITIAL_STATES, TS, U0_ATOL,
                                      V_REF, WEIGHTS, lbfgsb_reference,
                                      np_cost, np_f_d,
                                      straight_centerline_f64)


@pytest.mark.slow
@pytest.mark.parametrize("y0", [np.array(y) for y in PARITY_INITIAL_STATES])
def test_ocp_solution_matches_f64_reference(y0):
    p = VehicleParams()
    cl64 = straight_centerline_f64()

    # independent f64 solve (scipy L-BFGS-B, numerical gradients)
    ref_x = lbfgsb_reference(y0, p, cl64)

    # our solver
    prob = build_vehicle_ocp(n_horiz=N_HORIZ, v_ref=V_REF, ts=TS,
                             weights=WEIGHTS)
    solve = make_alm_solver(prob, AlmConfig(eps=1e-5),
                            PanocConfig(lbfgs_memory=12, max_iter=400))
    param = {"y0": jnp.asarray(y0, jnp.float32), "p": p,
             "centerline": straight_centerline(100)}
    res = solve(param, jnp.tile(jnp.asarray([1.0, 0.0], jnp.float32), N_HORIZ),
                jnp.zeros(prob.m, jnp.float32))

    ours = np.asarray(res.u, np.float64)
    # cost parity in the f64 ground-truth objective
    cost_ref = np_cost(ref_x, y0, cl64, p)
    cost_ours = np_cost(ours, y0, cl64, p)
    assert cost_ours <= cost_ref + COST_TOL, (cost_ours, cost_ref)
    # first-input parity (what actually drives the plant)
    np.testing.assert_allclose(ours[:2], ref_x[:2], atol=U0_ATOL)


# ---- constrained parity gates (the full ALM multiplier path) --------------
#
# The unconstrained gate above grounds the easy OCP; these two ground the
# bounded-D paths the reference exercises: the vehicle OCP with active
# quadratic state constraints (main.py:43-52 with the D bound enabled) and
# the hanging-chain OCP with its cubic floor (alpaqa_example.py:190-212).
# Oracle: f64 scipy SLSQP on an independent transcription.

NC = 6   # short horizon keeps the scipy oracle tractable


def np_state_constraints(u_flat, y0, p):
    """Stacked g(u) = x_i^2 - off_i per stage (main.py:43-52), f64."""
    offs = np.array([20.0, 1.0, 1.0, 2.0, 1.0, 0.1])
    us = u_flat.reshape(NC, 2)
    x = y0.copy()
    gs = []
    for k in range(NC):
        x = np_f_d(x, us[k], p)
        gs.append(x ** 2 - offs)
    return np.concatenate(gs)


@pytest.mark.slow
def test_constrained_vehicle_ocp_matches_f64_slsqp():
    # v_ref = 2.0 makes vx want to exceed sqrt(2): the vx^2 <= 2 constraint
    # BINDS, so this exercises real multipliers, not a feasible interior.
    from mpc_tpu.control.mpc import build_vehicle_controller

    p = VehicleParams()
    v_ref = 2.0
    # start just under the speed bound sqrt(2): v_ref=2 pushes the optimum
    # into the vx^2 <= 2 constraint within the short horizon
    y0 = np.array([0.0, 0.0, 0.0, 1.41, 0.0, 0.0])
    cl64 = straight_centerline_f64()
    u_init = np.tile([1.0, 0.0], NC)

    ref = minimize(
        np_cost, u_init, args=(y0, cl64, p, NC, v_ref), method="SLSQP",
        bounds=[(-1.0, 1.0), (-0.32, 0.32)] * NC,
        constraints=[{"type": "ineq",
                      "fun": lambda u: -np_state_constraints(u, y0, p)}],
        options={"maxiter": 300, "ftol": 1e-12})
    assert ref.success
    g_ref = np_state_constraints(ref.x, y0, p)
    assert g_ref.max() > -1e-3  # the oracle's constraint actually binds

    ctrl = build_vehicle_controller(
        n_horiz=NC, v_ref=v_ref, bound_state_constraints=True,
        alm_cfg=AlmConfig(eps=1e-4, delta=1e-4, max_iter=12, eps_0=1e-2),
        panoc_cfg=PanocConfig(lbfgs_memory=NC, max_iter=300))
    param = {"y0": jnp.asarray(y0, jnp.float32), "p": p,
             "centerline": straight_centerline(100)}
    res = ctrl.solve(param, jnp.asarray(u_init, jnp.float32),
                     jnp.zeros(ctrl.problem.m, jnp.float32))
    assert bool(res.converged)

    ours = np.asarray(res.u, np.float64)
    # feasible (to ALM delta) and as good as the oracle in the f64 objective
    assert np_state_constraints(ours, y0, p).max() <= 2e-3
    cost_ref = np_cost(ref.x, y0, cl64, p, NC, v_ref)
    cost_ours = np_cost(ours, y0, cl64, p, NC, v_ref)
    assert cost_ours <= cost_ref + 1e-3, (cost_ours, cost_ref)
    np.testing.assert_allclose(ours[:2], ref.x[:2], atol=2e-2)


@pytest.mark.slow
def test_chain_ocp_matches_f64_slsqp():
    from mpc_tpu.control.chain_mpc import (build_chain_ocp,
                                           floor_coefficients, g_constr)
    from mpc_tpu.models.chain import ChainSpec, chain_dynamics
    from mpc_tpu.models.integrators import discretize
    from mpc_tpu.models.params import ChainParams

    spec = ChainSpec(n_balls=6, dim=2)
    cp = ChainParams()
    nh = 4

    # f64 chain dynamics (independent transcription, alpaqa_example.py:44-64)
    def np_chain(y, u):
        n, d = spec.n_balls, spec.dim
        grav = np.array([0.0, -9.81])
        y1 = y[: n * d].reshape(n, d)
        y2 = y[n * d: 2 * n * d].reshape(n, d)
        y3 = y[2 * n * d:]
        f2 = []
        for i in range(n):
            xi = y1[i]
            xip1 = y1[i + 1] if i < n - 1 else y3
            xim1 = y1[i - 1] if i > 0 else np.zeros(d)
            fu = cp.D * (1 - cp.L / np.linalg.norm(xip1 - xi)) * (xip1 - xi)
            fd = cp.D * (1 - cp.L / np.linalg.norm(xi - xim1)) * (xi - xim1)
            f2.append((fu - fd) / cp.m + grav)
        return np.concatenate([y2.ravel(), np.concatenate(f2), u])

    def np_fd(y, u, ts=0.05, sub=4):
        h = ts / sub
        for _ in range(sub):
            k1 = np_chain(y, u)
            k2 = np_chain(y + 0.5 * h * k1, u)
            k3 = np_chain(y + 0.5 * h * k2, u)
            k4 = np_chain(y + h * k3, u)
            y = y + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
        return y

    coeff, lb = floor_coefficients()
    coeff64 = np.asarray(coeff, np.float64)
    x_end = np.array([1.0, 0.0])

    def np_chain_cost(u_flat, y0):
        us = u_flat.reshape(nh, 2)
        y = y0.copy()
        tot = 0.0
        n, d = spec.n_balls, spec.dim
        for k in range(nh):
            y = np_fd(y, us[k])
            tot += (25.0 * np.sum((y[2 * n * d:] - x_end) ** 2)
                    + np.sum(y[n * d: 2 * n * d] ** 2)
                    + 0.01 * np.sum(us[k] ** 2))
        return tot

    def np_chain_g(u_flat, y0):
        """Stacked floor constraints y_ball - g_c(x_ball) - lb >= 0."""
        us = u_flat.reshape(nh, 2)
        y = y0.copy()
        n, d = spec.n_balls, spec.dim
        gs = []
        for k in range(nh):
            y = np_fd(y, us[k])
            y1 = y[: n * d].reshape(n, d)
            gx = (coeff64[0] * y1[:, 0] ** 3 + coeff64[1] * y1[:, 0] ** 2
                  + coeff64[2] * y1[:, 0])
            gs.append(y1[:, 1] - gx - lb)
            gs.append(np.atleast_1d(
                y[-1] - (coeff64[0] * y[2 * n * d] ** 3
                         + coeff64[1] * y[2 * n * d] ** 2
                         + coeff64[2] * y[2 * n * d]) - lb))
        return np.concatenate(gs)

    # disturbed start (the reference's 3 disturbance steps,
    # alpaqa_example.py:158-161) so the floor constraint matters
    y = np.asarray(spec.initial_state(), np.float64)
    for _ in range(3):
        y = np_fd(y, np.array([-0.5, 0.5]))

    u_init = np.zeros(nh * 2)
    ref = minimize(
        np_chain_cost, u_init, args=(y,), method="SLSQP",
        bounds=[(-1.0, 1.0)] * (nh * 2),
        constraints=[{"type": "ineq", "fun": lambda u: np_chain_g(u, y)}],
        options={"maxiter": 300, "ftol": 1e-12})
    assert ref.success

    prob = build_chain_ocp(spec, n_horiz=nh)
    solve = make_alm_solver(
        prob, AlmConfig(eps=1e-4, delta=1e-4, sigma_0=1e5, max_iter=12,
                        eps_0=1e-2),
        PanocConfig(lbfgs_memory=nh * 2, max_iter=300))
    param = {"y0": jnp.asarray(y, jnp.float32), "p": cp,
             "constr": jnp.asarray(coeff)}
    res = solve(param, jnp.zeros(nh * 2, jnp.float32),
                jnp.zeros(prob.m, jnp.float32))
    assert bool(res.converged)

    ours = np.asarray(res.u, np.float64)
    assert np_chain_g(ours, y).min() >= -2e-3          # feasible to delta
    cost_ref = np_chain_cost(ref.x, y)
    cost_ours = np_chain_cost(ours, y)
    assert cost_ours <= cost_ref + max(1e-3, 1e-3 * abs(cost_ref)), \
        (cost_ours, cost_ref)

"""Independent float64 transcription of the vehicle OCP, and its scipy solve.

The parity oracle for the float32 solvers: the same OCP (RK4 rollout,
unnormalized road errors, tracking stage cost; reference main.py:25-59,
car_dynamics.py:113-258) reimplemented in plain numpy, shares no code with
the package, and is solved with scipy's L-BFGS-B. The reference's plant
equals its prediction model (main.py:145), so equal-OCP equal-solution
implies equal closed loop. Used by ``tests/test_ocp_parity.py`` and
``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

from mpc_tpu.models.params import VehicleParams

N_HORIZ = 12
TS = 0.05
V_REF = 1.0
WEIGHTS = (0.5, 1.0, 1.0, 0.5, 0.1, 0.01)

# Initial states of the unconstrained parity gate and its tolerances: the
# f32 solution's f64 cost may exceed the oracle's by COST_TOL, and its first
# input (what drives the plant) may differ by U0_ATOL.
PARITY_INITIAL_STATES = (
    (0.0, 0.0, 0.0, 0.5, 0.0, 0.0),
    (0.0, 0.15, 0.0, 0.5, 0.0, 0.0),
    (0.3, -0.05, 0.1, 0.8, 0.0, 0.0),
)
COST_TOL = 1e-5
U0_ATOL = 5e-3


def np_pacejka(x, u, p: VehicleParams):
    d, dl = u
    phi, vx, vy, w = x[2], x[3], x[4], x[5]
    af = -np.arctan2(w * p.axis_front + vy, vx) + dl
    ar = np.arctan2(w * p.axis_rear - vy, vx)
    frx = (p.cm1 - p.cm2 * vx) * d - p.cr0 * np.sign(vx) - p.cr2 * vx * vx
    ffy = p.df * np.sin(p.cf * np.arctan(p.bf * af))
    fry = p.dr * np.sin(p.cr * np.arctan(p.br * ar))
    return np.array([
        vx * np.cos(phi) - vy * np.sin(phi),
        vx * np.sin(phi) + vy * np.cos(phi),
        w,
        (frx - ffy * np.sin(dl) + p.mass * vy * w) / p.mass,
        (fry + ffy * np.cos(dl) - p.mass * vx * w) / p.mass,
        (ffy * p.axis_front * np.cos(dl) - fry * p.axis_rear) / p.inertia,
    ])


def np_f_d(x, u, p):
    h = TS / 4
    for _ in range(4):
        k1 = np_pacejka(x, u, p)
        k2 = np_pacejka(x + 0.5 * h * k1, u, p)
        k3 = np_pacejka(x + 0.5 * h * k2, u, p)
        k4 = np_pacejka(x + h * k3, u, p)
        x = x + (h / 6) * (k1 + 2 * k2 + 2 * k3 + k4)
    return x


def np_errors(pos, heading, cl):
    d2 = np.sum((cl[:-1] - pos) ** 2, axis=1)
    idx = int(np.argmin(d2))
    near, prev, nxt = cl[idx], cl[max(idx - 1, 0)], cl[idx + 1]
    v = pos - prev
    w = near - prev
    cte = v[0] * w[1] - v[1] * w[0]
    desired = np.arctan2(nxt[1] - near[1], nxt[0] - near[0])
    hdg = np.mod(desired - heading + np.pi, 2 * np.pi) - np.pi
    vn = pos - near
    wn = nxt - near
    pe = vn[0] * wn[1] - vn[1] * wn[0]
    return cte, hdg, pe


def np_cost(u_flat, y0, cl, p, n_horiz: int = N_HORIZ, v_ref: float = V_REF):
    us = u_flat.reshape(n_horiz, 2)
    x = y0.copy()
    total = 0.0
    c = WEIGHTS
    for k in range(n_horiz):
        x = np_f_d(x, us[k], p)
        cte, hdg, pe = np_errors(x[:2], x[2], cl)
        speed = np.sqrt(x[3] ** 2 + x[4] ** 2)
        total += (c[0] * (speed - v_ref) ** 2 + c[1] * cte ** 2
                  + c[2] * pe ** 2 + c[3] * hdg ** 2
                  + c[4] * us[k, 1] ** 2 + c[5] * us[k, 0] ** 2)
    return total


def straight_centerline_f64(size: int = 100) -> np.ndarray:
    """The straight road of ``ops.road.straight_centerline``, in float64."""
    return np.stack([np.arange(size) / 10 - 0.1, np.zeros(size)], axis=1)


def lbfgsb_reference(y0, p: VehicleParams, cl=None,
                     n_horiz: int = N_HORIZ) -> np.ndarray:
    """The oracle's optimal input sequence: scipy L-BFGS-B on ``np_cost``
    (numerical gradients) from the reference's warm start
    ``tile([1, 0], N)`` (controller.py:20)."""
    from scipy.optimize import minimize

    if cl is None:
        cl = straight_centerline_f64()
    res = minimize(np_cost, np.tile([1.0, 0.0], n_horiz),
                   args=(np.asarray(y0, np.float64), cl, p, n_horiz),
                   method="L-BFGS-B",
                   bounds=[(-1.0, 1.0), (-0.32, 0.32)] * n_horiz,
                   options={"maxiter": 500, "ftol": 1e-14, "gtol": 1e-9})
    return res.x

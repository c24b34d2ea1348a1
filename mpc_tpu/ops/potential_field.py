"""Driving potential fields — obstacle risk, lane keeping, road boundaries.

JAX-native re-design of the reference's visualization-only module
(reference: dpf_test.py:45-118; never wired into a controller there). Here
the fields are pure JAX functions evaluated over arbitrary batches of points
and obstacle sets, so they can (a) render the reference's heatmaps and (b)
act as differentiable obstacle costs inside the MPC stage cost.

Field definitions (reference values):
- ``obstacle_field``: rotated anisotropic Gaussian (sigma_x=2, sigma_y=0.5,
  Af=1000) scaled by exp(-alpha (x - x_obs)) with alpha = (v - v_obs)/5
  (dpf_test.py:81-102);
- ``lane_potential``: 0.5 a (y - y_target)^2 (dpf_test.py:45-46);
- ``boundary_potential``: b (y - y_bound)^2 outside [y_right, y_left]
  (dpf_test.py:49-54);
- ``safe_distances``: kinematic safe-gap helper (dpf_test.py:57-64).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# reference module constants (dpf_test.py:5-7)
Y_TARGET, Y_BOUND_RIGHT, Y_BOUND_LEFT = 1.75, 1.0, 6.0
X_0, Y_0, A_X_MAX, A_Y_MAX = 5.0, 3.0, 3.0, 1.0


def _rotate(x, y, theta):
    c, s = jnp.cos(theta), jnp.sin(theta)
    return c * x - s * y, s * x + c * y


def obstacle_field(x, y, phi, v, obs_x, obs_y, obs_phi, obs_v,
                   a_f: float = 1000.0, b: float = 1.0,
                   sigma_x: float = 2.0, sigma_y: float = 0.5):
    """Summed anisotropic Gaussian risk over obstacles (dpf_test.py:81-102).

    Point args are scalars (vmap for grids/batches); obstacle args are (K,)
    arrays. Both the evaluation point and each obstacle are rotated by the
    relative heading, and the field decays/steepens longitudinally with the
    relative speed.
    """
    theta = phi - obs_phi
    oxr, oyr = _rotate(obs_x, obs_y, theta)
    xr, yr = _rotate(x, y, theta)
    alpha = (v - obs_v) / 5.0
    expo = ((xr - oxr) ** 2 / (2 * sigma_x ** 2)
            + (yr - oyr) ** 2 / (2 * sigma_y ** 2)) ** b
    return jnp.sum(a_f * jnp.exp(-expo) * jnp.exp(-alpha * (xr - oxr)))


def lane_potential(y, y_target: float = Y_TARGET, a: float = 0.5):
    """Quadratic lane-keeping well (dpf_test.py:45-46)."""
    return a * (y - y_target) ** 2


def boundary_potential(y, y_right: float = Y_BOUND_RIGHT,
                       y_left: float = Y_BOUND_LEFT, b: float = 100.0):
    """One-sided quadratic walls outside the road (dpf_test.py:49-54)."""
    return jnp.where(y >= y_left, b * (y - y_left) ** 2,
                     jnp.where(y <= y_right, b * (y - y_right) ** 2, 0.0))


def total_field(x, y, phi, v, obs_x, obs_y, obs_phi, obs_v,
                y_target: float = Y_TARGET):
    """Obstacle + lane + boundary — the quantity the reference heatmaps
    (dpf_test.py:25-42)."""
    return (obstacle_field(x, y, phi, v, obs_x, obs_y, obs_phi, obs_v)
            + lane_potential(y, y_target)
            + boundary_potential(y))


def field_grid(xs, ys, phi, v, obs_x, obs_y, obs_phi, obs_v):
    """Evaluate the total field on a grid: returns (len(ys), len(xs))."""
    def row(y):
        return jax.vmap(lambda x: total_field(x, y, phi, v, obs_x, obs_y,
                                              obs_phi, obs_v))(xs)
    return jax.vmap(row)(ys)


def safe_distances(ego_state, obs_state):
    """Kinematic longitudinal/lateral safe gaps (dpf_test.py:57-64).

    States are ``[x, y, vx, vy]``.
    """
    x_s = X_0 / 2 + (ego_state[2] - obs_state[2]) ** 2 / (2 * A_X_MAX)
    y_s = Y_0 / 2 + (ego_state[3] - obs_state[3]) ** 2 / (2 * A_Y_MAX)
    return x_s, y_s


def obstacle_stage_cost(x_state, obstacles, weight: float = 1.0,
                        a_f: float = 10.0, sigma_x: float = 0.2,
                        sigma_y: float = 0.1):
    """Differentiable obstacle-avoidance term for the vehicle stage cost.

    Evaluates the risk field at the vehicle pose (state ``[x, y, phi, vx,
    vy, omega]``) against ``obstacles`` of shape (K, 4) rows ``[x, y, phi,
    v]`` (the ScenarioBatch layout). The reference's field (dpf_test.py:
    81-102) is visualization-only and road-scale (sigma_x=2 m); the defaults
    here are rescaled to the 1:43 RC-car world (0.1 m road spacing) so the
    field actually steers the OCP. Wired into ``build_vehicle_ocp`` via
    ``obstacle_weight`` (control/mpc.py)."""
    return weight * obstacle_field(
        x_state[0], x_state[1], x_state[2], x_state[3],
        obstacles[:, 0], obstacles[:, 1], obstacles[:, 2], obstacles[:, 3],
        a_f=a_f, sigma_x=sigma_x, sigma_y=sigma_y)

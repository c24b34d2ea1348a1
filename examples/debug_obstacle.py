"""Diagnostic: obstacle-avoidance closed loop on CPU (config #5 obstacle
term tuning)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.sim.closedloop import run_closed_loop_jit

PARAMS = VehicleParams()


def run(obstacle_weight, n_sim=40):
    ctrl = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=200),
        obstacle_weight=obstacle_weight)
    f_d = discretize(pacejka_dynamics)
    cl = straight_centerline(100)
    obs = jnp.asarray([[1.0, 0.0, 0.0, 0.0]], jnp.float32)  # on the line
    y0 = jnp.array([0.0, 0.0, 0.0, 0.5, 0.0, 0.0])
    run_ = run_closed_loop_jit(ctrl, f_d, n_sim=n_sim)
    static = {"p": PARAMS, "centerline": cl}
    if obstacle_weight > 0:
        static["obstacles"] = obs
    out = run_(y0, static, PARAMS)
    ys = np.asarray(out.ys)
    d = np.sqrt((ys[:, 0] - 1.0) ** 2 + (ys[:, 1] - 0.0) ** 2)
    print(f"w={obstacle_weight}: min_dist={d.min():.4f} "
          f"max|y|={np.abs(ys[:, 1]).max():.4f} x_end={ys[-1, 0]:.3f} "
          f"v_end={ys[-1, 3]:.3f} fail={int(out.carry.failures)}", flush=True)
    return d.min()


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    run(0.0)
    run(1.0)

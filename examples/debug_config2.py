"""Diagnostic: config #2 (N=40, Pacejka, Bezier road, bounded state
constraints) closed loop on CPU with per-step solver stats."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import (STATE_CONSTRAINT_OFFSETS,
                                 build_vehicle_controller)
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.bezier import bezier_centerline, lane_change_control_points

PARAMS = VehicleParams()


def main():
    pts = lane_change_control_points(5.0).control_points * 0.01
    cl = bezier_centerline(pts, size=100)
    import json
    knobs = json.loads(os.environ.get("CFG2", "{}"))
    alm = AlmConfig(eps=knobs.get("eps", 1e-3), delta=knobs.get("delta", 1e-3),
                    max_iter=knobs.get("max_outer", 8),
                    eps_0=knobs.get("eps_0", 1e-2),
                    sigma_0=knobs.get("sigma_0", 1e5))
    ctrl = build_vehicle_controller(
        n_horiz=40, bound_state_constraints=True, alm_cfg=alm,
        panoc_cfg=PanocConfig(lbfgs_memory=40,
                              max_iter=knobs.get("max_inner", 150)))
    f_d = discretize(pacejka_dynamics)
    d0 = cl[1] - cl[0]
    y0 = jnp.array([float(cl[0, 0]), float(cl[0, 1]),
                    float(jnp.arctan2(d0[1], d0[0])), 0.4, 0.0, 0.0])

    step = jax.jit(ctrl.step)
    carry = ctrl.init_carry()
    y = y0
    offs = np.asarray(STATE_CONSTRAINT_OFFSETS)
    for n in range(12):
        out = step(carry, {"y0": y, "p": PARAMS, "centerline": cl})
        carry = out.carry
        r = out.result
        y = f_d(y, out.u0, PARAMS)
        gmax = float((np.asarray(y) ** 2 - offs).max())
        print(f"step {n:2d}: conv={bool(r.converged)} outer={int(r.outer_iterations)}"
              f" inner={int(r.inner_iterations)} viol={float(r.constraint_violation):.2e}"
              f" psi={float(r.psi):.4f} gam={float(r.gamma):.2e}"
              f" sig=[{float(r.sigma.min()):.1e},{float(r.sigma.max()):.1e}]"
              f" gmax={gmax:.2e} v={float(y[3]):.3f}", flush=True)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

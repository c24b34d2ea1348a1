"""Diagnostic: multiple-shooting vehicle solve with per-outer ALM trace."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_ocp
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.costs import vehicle_stage_cost
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.solver.alm import make_alm_solver
from mpc_tpu.solver.multiple_shooting import (build_ms_ocp_problem,
                                              ms_warm_start, unpack_decision)
from mpc_tpu.solver.problem import Box

PARAMS = VehicleParams()
N = 12
M = 4


def main():
    import json
    knobs = json.loads(os.environ.get("MS", "{}"))
    f_d = discretize(pacejka_dynamics)

    def stage_cost(x, u, param):
        return vehicle_stage_cost(x, u, param["centerline"], 1.0)

    C_in = Box(jnp.tile(jnp.array([-1.0, -0.32], jnp.float32), N),
               jnp.tile(jnp.array([1.0, 0.32], jnp.float32), N))
    kw = {}
    if knobs.get("state_bound"):
        kw["state_bound"] = jnp.asarray(knobs["state_bound"], jnp.float32)
    prob, lo = build_ms_ocp_problem(f_d, stage_cost, N, M, 6, 2, C_in, **kw)

    alm = AlmConfig(eps=knobs.get("eps", 1e-4), delta=knobs.get("delta", 1e-5),
                    max_iter=knobs.get("max_outer", 15),
                    eps_0=knobs.get("eps_0", 1e-3),
                    sigma_0=knobs.get("sigma_0", 10.0),
                    penalty_factor=knobs.get("penalty_factor", 5.0),
                    trace=True)
    pan = PanocConfig(lbfgs_memory=2 * N,
                      max_iter=knobs.get("max_inner", 300),
                      trace=knobs.get("inner_trace", False))
    solve = jax.jit(make_alm_solver(prob, alm, pan))

    y0 = jnp.array([0.0, 0.05, 0.0, 0.5, 0.0, 0.0])
    param = {"y0": y0, "p": PARAMS, "centerline": straight_centerline(100)}
    us0 = jnp.tile(jnp.array([1.0, 0.0], jnp.float32), N)
    z0 = ms_warm_start(f_d, lo, y0, us0, PARAMS)
    res = solve(param, z0, jnp.zeros(prob.m, jnp.float32))
    tr = res.trace
    for k in range(int(res.outer_iterations)):
        print(f"outer {k:2d}: psi={float(tr.psi[k]):.4e}"
              f" viol={float(tr.violation[k]):.3e}"
              f" eps_k={float(tr.eps_k[k]):.1e}"
              f" sig_max={float(tr.sigma_max[k]):.1e}"
              f" inner={int(tr.inner_iters[k])}", flush=True)
    print(f"final: conv={bool(res.converged)} viol="
          f"{float(res.constraint_violation):.3e} psi={float(res.psi):.4e}")
    if res.inner_trace is not None:
        it = res.inner_trace
        n_it = int(np.sum(~np.isnan(np.asarray(it.psi))))
        for j in range(n_it):
            print(f"  inner {j:3d}: psi={float(it.psi[j]):.5e}"
                  f" crit={float(it.criterion[j]):.3e}"
                  f" gam={float(it.gamma[j]):.3e}", flush=True)
    us_ms, xs = unpack_decision(res.u, lo)
    print("x_starts:\n", np.asarray(xs))

    ss = build_vehicle_ocp(n_horiz=N)
    c_from_ms = float(ss.cost(us_ms.reshape(-1), param))
    print(f"ss-cost of MS inputs: {c_from_ms:.4f}")


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

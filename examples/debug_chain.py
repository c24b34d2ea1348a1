"""Diagnostic: hanging-chain MPC closed loop on CPU with per-step stats."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

import json

import jax.numpy as jnp
import numpy as np

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.chain_mpc import (build_chain_controller,
                                       floor_coefficients, g_constr)
from mpc_tpu.models.chain import ChainSpec, chain_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import ChainParams

SPEC = ChainSpec(n_balls=6, dim=2)
PARAMS = ChainParams()


def main():
    knobs = json.loads(os.environ.get("CFG", "{}"))
    alm = AlmConfig(eps=knobs.get("eps", 1e-4), delta=knobs.get("delta", 1e-4),
                    sigma_0=knobs.get("sigma_0", 1e5),
                    max_iter=knobs.get("max_outer", 12),
                    eps_0=knobs.get("eps_0", 1e-2))
    ctrl = build_chain_controller(
        SPEC, n_horiz=12, alm_cfg=alm,
        panoc_cfg=PanocConfig(lbfgs_memory=12,
                              max_iter=knobs.get("max_inner", 150)))
    f_d = discretize(chain_dynamics(SPEC))
    y = SPEC.initial_state()
    u_dist = jnp.array([-0.5, 0.5])
    for _ in range(3):
        y = f_d(y, u_dist, PARAMS)
    coeff, lb = floor_coefficients()

    step = jax.jit(ctrl.step)
    carry = ctrl.init_carry()
    n, d = SPEC.n_balls, SPEC.dim
    worst = []
    for k in range(60):
        out = step(carry, {"y0": y, "p": PARAMS, "constr": coeff})
        carry = out.carry
        r = out.result
        y = f_d(y, out.u0, PARAMS)
        y1 = np.asarray(y)[: n * d].reshape(n, d)
        gx = np.asarray(jax.vmap(lambda x: g_constr(coeff, x))(
            jnp.asarray(y1[:, 0])))
        viol_floor = float(((gx + lb) - y1[:, 1]).max())
        worst.append(viol_floor)
        if k % 5 == 0 or not bool(r.converged):
            print(f"step {k:2d}: conv={bool(r.converged)} "
                  f"outer={int(r.outer_iterations)} "
                  f"inner={int(r.inner_iterations)} "
                  f"viol={float(r.constraint_violation):.2e} "
                  f"floor={viol_floor:+.4f} "
                  f"sig=[{float(r.sigma.min()):.1e},{float(r.sigma.max()):.1e}]"
                  f" gam={float(r.gamma):.2e}", flush=True)
    dist = float(np.linalg.norm(np.asarray(y)[-2:] - np.array([1.0, 0.0])))
    print(f"final free-end dist={dist:.4f} max floor viol={max(worst):.4f}",
          flush=True)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

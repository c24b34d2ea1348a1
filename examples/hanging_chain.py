"""Hanging-chain MPC demo (reference: alpaqa_example.py end-to-end flow).

Disturb the chain for 3 steps, simulate the uncontrolled system, then run
the constrained MPC closed loop and report convergence/constraint stats.

Run:  python examples/hanging_chain.py [--n-sim 180] [--plot out.png]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from mpc_tpu.config import PanocConfig
from mpc_tpu.control.chain_mpc import (build_chain_controller,
                                       floor_coefficients, g_constr)
from mpc_tpu.models.chain import ChainSpec, chain_dynamics, chain_state_to_pos
from mpc_tpu.models.integrators import discretize, rollout
from mpc_tpu.models.params import ChainParams
from mpc_tpu.sim.closedloop import run_closed_loop_jit


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-sim", type=int, default=180)
    ap.add_argument("--plot", type=str, default="")
    args = ap.parse_args()

    spec = ChainSpec(n_balls=6, dim=2)
    params = ChainParams()
    f_d = discretize(chain_dynamics(spec))

    # disturb (alpaqa_example.py:158-161)
    y = spec.initial_state()
    for _ in range(3):
        y = f_d(y, jnp.array([-0.5, 0.5]), params)

    # uncontrolled simulation (alpaqa_example.py:165-167)
    y_free = rollout(f_d, y, jnp.zeros((args.n_sim, 2)), params)

    ctrl = build_chain_controller(
        spec, n_horiz=12, panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=250))
    coeff, lb = floor_coefficients()
    run = run_closed_loop_jit(ctrl, f_d, n_sim=args.n_sim)

    t0 = time.perf_counter()
    out = run(y, {"p": params, "constr": coeff}, params)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    ys = np.asarray(out.ys)
    print(int(out.carry.tot_it), int(out.carry.failures))

    n, d = spec.n_balls, spec.dim
    y1 = ys[:, : n * d].reshape(-1, n, d)
    gx = np.asarray(jax.vmap(lambda x: g_constr(coeff, x))(
        jnp.asarray(y1[..., 0].ravel()))).reshape(y1.shape[0], n)
    viol_mpc = float(((gx + lb) - y1[..., 1]).max())

    yf1 = np.asarray(y_free)[:, : n * d].reshape(-1, n, d)
    gxf = np.asarray(jax.vmap(lambda x: g_constr(coeff, x))(
        jnp.asarray(yf1[..., 0].ravel()))).reshape(yf1.shape[0], n)
    viol_free = float(((gxf + lb) - yf1[..., 1]).max())

    print(json.dumps({
        "n_sim": args.n_sim, "wall_s": round(dt, 3),
        "free_end_final": [round(float(v), 4) for v in ys[-1, -2:]],
        "max_floor_violation_mpc": round(viol_mpc, 4),
        "max_floor_violation_uncontrolled": round(viol_free, 4),
    }))

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots()
        for k, (traj, label) in enumerate(
                [(np.asarray(y_free), "without MPC"), (ys, "with MPC")]):
            xs, yy, _ = chain_state_to_pos(spec, jnp.asarray(traj[-1]))
            ax.plot(np.asarray(xs), np.asarray(yy), "-o", label=label)
        xs_f = np.linspace(-0.25, 1.25, 200)
        ax.plot(xs_f, np.asarray(jax.vmap(
            lambda x: g_constr(coeff, x))(jnp.asarray(xs_f))) + lb,
            "g--", label="floor")
        ax.legend()
        fig.savefig(args.plot, dpi=100)
        print("saved", args.plot)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

"""Closed-loop vehicle MPC demo — the reference's primary entry point.

JAX-native analogue of ``alpaqa_vehicle_test`` (reference: main.py:62-177):
400 steps, horizon 12, straight (or circular) 100-point centerline,
v_ref = 1.0 — but the entire closed loop (solver included) is one compiled
``lax.scan``, optionally batched over many initial states.

Run:  python examples/vehicle_mpc.py [--circle] [--batch B] [--plot out.png]
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

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import circle_centerline, straight_centerline
from mpc_tpu.sim.closedloop import run_closed_loop_jit
from mpc_tpu.utils.timing import StepMetrics


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--circle", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--n-sim", type=int, default=400)
    ap.add_argument("--n-horiz", type=int, default=12)
    ap.add_argument("--plot", type=str, default="")
    args = ap.parse_args()

    ctrl = build_vehicle_controller(
        n_horiz=args.n_horiz, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=args.n_horiz, max_iter=300))
    params = VehicleParams()
    f_d = discretize(pacejka_dynamics)
    cl = circle_centerline(100) if args.circle else straight_centerline(100)

    # reference initial state (main.py:72-79)
    y0 = jnp.array([0.0, 0.0, 0.0, 0.5, 0.0, 0.0])
    if args.circle:
        y0 = jnp.array([5.0, 5.0, float(jnp.pi / 2), 0.5, 0.0, 0.0])

    run = run_closed_loop_jit(ctrl, f_d, n_sim=args.n_sim)
    static = {"p": params, "centerline": cl}

    if args.batch:
        rng = np.random.default_rng(0)
        y0s = np.tile(np.asarray(y0), (args.batch, 1)).astype(np.float32)
        y0s[:, 3] = rng.uniform(0.3, 1.0, args.batch)
        vrun = jax.jit(jax.vmap(lambda y: run(y, static, params)))
        t0 = time.perf_counter()
        out = vrun(jnp.asarray(y0s))
        jax.block_until_ready(out)
        dt = time.perf_counter() - t0
        conv = np.asarray(out.converged)
        print(json.dumps({
            "batch": args.batch, "n_sim": args.n_sim,
            "wall_s": round(dt, 3),
            "solves_per_s": round(args.batch * args.n_sim / dt, 1),
            "converged_fraction": float(conv.mean()),
        }))
        return

    t0 = time.perf_counter()
    out = run(y0, static, params)
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    ys = np.asarray(out.ys)
    # reference prints tot_it and failures at the end (main.py:154)
    print(int(out.carry.tot_it), int(out.carry.failures))
    print(json.dumps({
        "n_sim": args.n_sim, "wall_s": round(dt, 3),
        "final_state": [round(float(v), 4) for v in ys[-1]],
        "mean_speed": round(float(ys[:, 3].mean()), 4),
    }))

    if args.plot:
        from mpc_tpu.viz.plots import plot_closed_loop
        plot_closed_loop(cl, ys, "vehicle closed loop", args.plot)
        print("saved", args.plot)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

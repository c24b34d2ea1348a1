"""Randomized scenario suite end-to-end (BASELINE.json config #5).

Generates N randomized road/obstacle scenarios with the native C++ generator
(background-prefetched), rolls them through the batched MPC closed loop in
checkpointed segments, and reports aggregate metrics.

Run:  python examples/scenario_suite.py [--batch 2048] [--n-sim 50]
      [--checkpoint ck.npz]
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
from mpc_tpu.io.native_scenarios import generate_scenarios, native_available
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.sim.scenarios import run_scenario_suite_resumable


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--n-sim", type=int, default=50)
    ap.add_argument("--segment", type=int, default=10)
    ap.add_argument("--checkpoint", type=str, default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    print(f"native generator: {native_available()}")
    t0 = time.perf_counter()
    sc = generate_scenarios(seed=args.seed, batch=args.batch, size=100)
    t_gen = time.perf_counter() - t0
    sc = sc._replace(y0=jnp.asarray(sc.y0),
                     centerline=jnp.asarray(sc.centerline))

    ctrl = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=60))
    f_d = discretize(pacejka_dynamics)

    t0 = time.perf_counter()
    state, conv = run_scenario_suite_resumable(
        ctrl, f_d, sc, VehicleParams(), args.n_sim, segment=args.segment,
        checkpoint_path=args.checkpoint or None)
    dt = time.perf_counter() - t0

    ys = np.asarray(state["ys"])
    print(json.dumps({
        "batch": args.batch, "n_sim": args.n_sim,
        "generation_s": round(t_gen, 3),
        "rollout_s": round(dt, 3),
        "solves_per_s": round(args.batch * args.n_sim / dt, 1),
        "converged_fraction": round(float(conv.mean()), 4) if conv is not None
        else None,
        "nan_scenarios": int(np.isnan(ys).any(axis=1).sum()),
        "mean_final_speed": round(float(np.abs(ys[:, 3]).mean()), 4),
    }))


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

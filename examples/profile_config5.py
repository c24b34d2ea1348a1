"""Profile of BASELINE config #5 (randomized scenario suite, two-tier).

Prints the per-step tier breakdown (cheap wall, straggler wall, straggler
count) that ``run_scenario_suite_two_tier`` collects, so the slow tier is
measured instead of guessed.

Run:  python examples/profile_config5.py [--batch 512] [--n-sim 6] [--record]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json
import time

import jax.numpy as jnp
import numpy as np

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.io.native_scenarios import generate_scenarios
from mpc_tpu.sim.scenarios import run_scenario_suite_two_tier

PARAMS = VehicleParams()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--n-sim", type=int, default=6)
    ap.add_argument("--cheap-iters", type=int, default=40)
    ap.add_argument("--cheap-outer", type=int, default=20)
    ap.add_argument("--full-outer", type=int, default=20)
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--record-key", default="10")
    args = ap.parse_args()

    sc = generate_scenarios(seed=0, batch=args.batch, size=100)
    sc = sc._replace(y0=jnp.asarray(sc.y0),
                     centerline=jnp.asarray(sc.centerline),
                     obstacles=jnp.asarray(sc.obstacles))
    ctrl_full = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4, max_iter=args.full_outer),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=150))
    ctrl_cheap = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4, max_iter=args.cheap_outer),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=args.cheap_iters))
    f_d = discretize(pacejka_dynamics)

    # warm-up/compile: cheap shape + at least one straggler shape
    run_scenario_suite_two_tier(ctrl_full, ctrl_cheap, f_d, sc, PARAMS, 2)
    t0 = time.perf_counter()
    state, conv = run_scenario_suite_two_tier(ctrl_full, ctrl_cheap, f_d, sc,
                                              PARAMS, args.n_sim)
    dt = time.perf_counter() - t0
    st = state["stats"]
    row = {
        "exp": "two_tier_profile", "batch": args.batch, "n_sim": args.n_sim,
        "cheap_iters": args.cheap_iters, "cheap_outer": args.cheap_outer,
        "solves_per_s": round(args.batch * args.n_sim / dt, 1),
        "wall_s": round(dt, 2),
        "cheap_s_per_step": [round(t, 2) for t in st["cheap_s"]],
        "straggler_s_per_step": [round(t, 2) for t in st["straggler_s"]],
        "n_stragglers_per_step": st["n_stragglers"],
        "converged_fraction": round(float(conv.mean()), 5),
    }
    print(json.dumps(row), flush=True)

    if args.record:
        from mpc_tpu.utils import perfdb
        rec = {"config": f"{args.record_key}: config #5 two-tier profile",
               "source": "examples/profile_config5.py",
               "result": (f"{row['solves_per_s']} solves/s at batch "
                          f"{args.batch} (conv {row['converged_fraction']})"),
               "cheap_s_per_step": str(row["cheap_s_per_step"]),
               "straggler_s_per_step": str(row["straggler_s_per_step"]),
               "n_stragglers_per_step": str(row["n_stragglers_per_step"])}
        perfdb.record(args.record_key, rec)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

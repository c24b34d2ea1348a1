"""Experiment: multiple-shooting vs single-shooting at long horizon.

BASELINE config #2 shape (dynamic bicycle, Bezier road, N=40, bounded state
constraints) solved two ways:
  - ss: single shooting — sequential rollout depth N per cost evaluation
  - ms: multiple shooting, M segments — rollout depth N/M (vmapped over
    segments), defects handled by the ALM layer

Run:  python examples/exp_ms.py [--batch 256] [--segments 8] [--n-steps 6]
Prints one JSON line per variant.
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
from mpc_tpu.control.mpc import (build_vehicle_controller,
                                 build_vehicle_ms_controller)
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.bezier import bezier_centerline, lane_change_control_points

PARAMS = VehicleParams()
N = 40


RESULTS = []


def bench(name, ctrl, cl, y0s, n_steps, unroll_note=""):
    f_d = discretize(pacejka_dynamics)
    batch = y0s.shape[0]

    @jax.jit
    def step(ys, carries):
        def one(y, c):
            out = ctrl.step(c, {"y0": y, "p": PARAMS, "centerline": cl})
            return (f_d(y, out.u0, PARAMS), out.carry,
                    out.result.converged, out.result.inner_iterations)
        return jax.vmap(one)(ys, carries)

    carries = jax.vmap(lambda _: ctrl.init_carry())(jnp.arange(batch))
    ys = y0s
    t0 = time.perf_counter()
    for _ in range(3):
        ys, carries, conv, iters = step(ys, carries)
    jax.block_until_ready(ys)
    warm_s = time.perf_counter() - t0

    ts, convs, its = [], [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        ys, carries, conv, iters = step(ys, carries)
        jax.block_until_ready(ys)
        ts.append(time.perf_counter() - t0)
        convs.append(float(jnp.mean(conv.astype(jnp.float32))))
        its.append(float(jnp.mean(iters)))
    p50 = float(np.median(ts))
    row = {
        "exp": name, "batch": batch, "n_horiz": N,
        "solves_per_s": round(batch / p50, 1),
        "p50_step_s": round(p50, 4),
        "warmup_s": round(warm_s, 1),
        "converged_fraction": round(float(np.mean(convs)), 4),
        "mean_inner_iters": round(float(np.mean(its)), 1),
        "note": unroll_note,
    }
    RESULTS.append(row)
    print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--n-steps", type=int, default=6)
    ap.add_argument("--variants", nargs="*", default=["ss", "ms", "ilqr"])
    ap.add_argument("--ilqr-alphas", type=int, default=0,
                    help="line-search fan size (0 -> IlqrConfig default)")
    ap.add_argument("--ilqr-unroll", type=int, default=1)
    ap.add_argument("--record", action="store_true",
                    help="write the comparison into .perf_results.json/"
                         "PERF.md (utils/perfdb)")
    args = ap.parse_args()

    pts = lane_change_control_points(5.0).control_points * 0.01
    cl = bezier_centerline(pts, size=100)
    d0 = cl[1] - cl[0]
    hd = float(jnp.arctan2(d0[1], d0[0]))
    rng = np.random.default_rng(0)
    y0s = np.zeros((args.batch, 6), np.float32)
    y0s[:, 0] = float(cl[0, 0])
    y0s[:, 1] = float(cl[0, 1]) + rng.uniform(-0.02, 0.02, args.batch)
    y0s[:, 2] = hd
    y0s[:, 3] = rng.uniform(0.2, 0.8, args.batch)
    y0s = jnp.asarray(y0s)

    # bounded unroll keeps the N=40 programs' compile time small
    unroll = 8

    if "ss" in args.variants:
        ctrl_ss = build_vehicle_controller(
            n_horiz=N, bound_state_constraints=True,
            alm_cfg=AlmConfig(eps=1e-3, delta=1e-3, max_iter=8, eps_0=1e-2,
                              sigma_0=1e3),
            panoc_cfg=PanocConfig(lbfgs_memory=N, max_iter=150),
            unroll=unroll)
        bench("ss_n40", ctrl_ss, cl, y0s, args.n_steps, f"unroll={unroll}")

    if "ilqr" in args.variants:
        from mpc_tpu.control.mpc import build_vehicle_ilqr_controller
        from mpc_tpu.solver.ilqr import IlqrConfig
        alphas = tuple(0.5 ** i for i in range(args.ilqr_alphas)) \
            if args.ilqr_alphas else IlqrConfig._field_defaults["alphas"]
        ctrl_il = build_vehicle_ilqr_controller(
            n_horiz=N, bound_state_constraints=True,
            alm_cfg=AlmConfig(delta=1e-3, max_iter=8, sigma_0=1e3,
                              penalty_factor=5.0),
            ilqr_cfg=IlqrConfig(max_iter=30, alphas=alphas,
                                unroll=args.ilqr_unroll))
        bench("ilqr_n40", ctrl_il, cl, y0s, args.n_steps,
              f"AL-iLQR, sequential Riccati (IlqrConfig default), "
              f"alphas={len(alphas)}, unroll={args.ilqr_unroll}")

    if "ms" in args.variants:
        ctrl_ms, _ = build_vehicle_ms_controller(
            n_horiz=N, n_segments=args.segments, bound_state_constraints=True,
            alm_cfg=AlmConfig(eps=1e-3, delta=1e-3, max_iter=8, eps_0=1e-2,
                              sigma_0=1e3, penalty_factor=5.0),
            panoc_cfg=PanocConfig(lbfgs_memory=N, max_iter=150))
        bench(f"ms_n40_m{args.segments}", ctrl_ms, cl, y0s, args.n_steps,
              f"segments={args.segments}")

    if args.record and RESULTS:
        from mpc_tpu.utils import perfdb
        rec = {"config": "7: ss vs ms vs ilqr at N=40 (config #2 shape)",
               "source": "examples/exp_ms.py --record"}
        for row in RESULTS:
            rec[row["exp"]] = (f"{row['solves_per_s']} solves/s, "
                               f"conv {row['converged_fraction']}, "
                               f"p50 {row['p50_step_s']} s ({row['note']})")
        perfdb.record("7", rec)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

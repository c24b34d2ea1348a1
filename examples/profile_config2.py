"""Profile of BASELINE config #2 (Pacejka, Bezier road, N=40, bounded
state constraints) on the AL-iLQR path — where does the per-step time go?

Black-box decomposition: the per-MPC-step cost is
    t_step ~= overhead + n_outer * (t_outer_fixed + n_inner * t_iter)
so sweeping iteration caps at fixed batch gives the per-inner-iteration and
per-outer-iteration costs by finite differences, while the iteration
statistics (mean/max outer+inner per step, straight from AlmResult) say how
many of each a warm MPC step actually needs.

Run one sweep per process:
    python examples/profile_config2.py --batch 256 --sweep iters
    python examples/profile_config2.py --sweep batch
    python examples/profile_config2.py --sweep alphas
Each prints one JSON line per point; --record writes the sweep through
utils/perfdb.
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

from mpc_tpu.config import AlmConfig
from mpc_tpu.control.mpc import build_vehicle_ilqr_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.bezier import bezier_centerline, lane_change_control_points
from mpc_tpu.solver.ilqr import IlqrConfig

PARAMS = VehicleParams()
N = 40
RESULTS = []


def setup(batch):
    pts = lane_change_control_points(5.0).control_points * 0.01
    cl = bezier_centerline(pts, size=100)
    d0 = cl[1] - cl[0]
    hd = float(jnp.arctan2(d0[1], d0[0]))
    rng = np.random.default_rng(0)
    y0s = np.zeros((batch, 6), np.float32)
    y0s[:, 0] = float(cl[0, 0])
    y0s[:, 1] = float(cl[0, 1]) + rng.uniform(-0.02, 0.02, batch)
    y0s[:, 2] = hd
    y0s[:, 3] = rng.uniform(0.2, 0.8, batch)
    return cl, jnp.asarray(y0s)


def bench_point(tag, batch, max_outer=8, max_inner=30, n_alphas=0,
                unroll=1, n_steps=6, n_warm=3, delta=1e-3,
                parallel_backward=True):
    cl, y0s = setup(batch)
    alphas = (tuple((0.5 ** i for i in range(n_alphas))) if n_alphas
              else IlqrConfig._field_defaults["alphas"])
    ctrl = build_vehicle_ilqr_controller(
        n_horiz=N, bound_state_constraints=True,
        alm_cfg=AlmConfig(delta=delta, max_iter=max_outer, sigma_0=1e3,
                          penalty_factor=5.0),
        ilqr_cfg=IlqrConfig(max_iter=max_inner, alphas=alphas,
                            unroll=unroll,
                            parallel_backward=parallel_backward))
    f_d = discretize(pacejka_dynamics)

    @jax.jit
    def step(ys, carries):
        def one(y, c):
            out = ctrl.step(c, {"y0": y, "p": PARAMS, "centerline": cl})
            return (f_d(y, out.u0, PARAMS), out.carry, out.result.converged,
                    out.result.outer_iterations, out.result.inner_iterations)
        return jax.vmap(one)(ys, carries)

    carries = jax.vmap(lambda _: ctrl.init_carry())(jnp.arange(batch))
    ys = y0s
    t0 = time.perf_counter()
    for _ in range(n_warm):
        ys, carries, conv, outer, inner = step(ys, carries)
    jax.block_until_ready(ys)
    warm_s = time.perf_counter() - t0

    ts, st = [], {"conv": [], "o_mean": [], "o_max": [], "i_mean": [],
                  "i_max": []}
    for _ in range(n_steps):
        t0 = time.perf_counter()
        ys, carries, conv, outer, inner = step(ys, carries)
        jax.block_until_ready(ys)
        ts.append(time.perf_counter() - t0)
        st["conv"].append(float(jnp.mean(conv.astype(jnp.float32))))
        st["o_mean"].append(float(jnp.mean(outer)))
        st["o_max"].append(float(jnp.max(outer)))
        st["i_mean"].append(float(jnp.mean(inner)))
        st["i_max"].append(float(jnp.max(inner)))
    p50 = float(np.median(ts))
    row = {
        "exp": tag, "batch": batch, "max_outer": max_outer,
        "max_inner": max_inner, "n_alphas": len(alphas), "unroll": unroll,
        "solves_per_s": round(batch / p50, 1),
        "p50_step_s": round(p50, 4),
        "warmup_s": round(warm_s, 1),
        "converged_fraction": round(float(np.mean(st["conv"])), 4),
        "outer_mean": round(float(np.mean(st["o_mean"])), 2),
        "outer_max": round(float(np.max(st["o_max"])), 1),
        "inner_mean": round(float(np.mean(st["i_mean"])), 1),
        "inner_max": round(float(np.max(st["i_max"])), 1),
    }
    RESULTS.append(row)
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", choices=["batch", "iters", "alphas", "unroll",
                                        "backward", "point"], default="point")
    ap.add_argument("--seq", action="store_true",
                    help="sequential Riccati backward pass (default: "
                         "parallel associative scan)")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--max-outer", type=int, default=8)
    ap.add_argument("--max-inner", type=int, default=30)
    ap.add_argument("--n-alphas", type=int, default=0)
    ap.add_argument("--unroll", type=int, default=None)
    ap.add_argument("--n-steps", type=int, default=6)
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--record-key", default="9")
    args = ap.parse_args()

    pb = not args.seq
    if args.sweep == "batch":
        for b in (128, 256, 512, 1024):
            bench_point(f"b{b}", b, args.max_outer, args.max_inner,
                        args.n_alphas, args.unroll, args.n_steps,
                        parallel_backward=pb)
    elif args.sweep == "backward":
        # end-to-end parallel-scan vs sequential Riccati (the phases profile
        # puts sequential ~5x faster per iteration at batch >= 128)
        for tag, p in (("par", True), ("seq", False)):
            bench_point(tag, args.batch, args.max_outer, args.max_inner,
                        args.n_alphas, args.unroll, args.n_steps,
                        parallel_backward=p)
    elif args.sweep == "iters":
        # slope: per-inner-iteration cost at max_outer=1
        for mi in (1, 2, 4, 8):
            bench_point(f"o1_i{mi}", args.batch, 1, mi, args.n_alphas,
                        args.unroll, args.n_steps, parallel_backward=pb)
        # outer cost: max_inner=1, vary outer
        for mo in (2, 4):
            bench_point(f"o{mo}_i1", args.batch, mo, 1, args.n_alphas,
                        args.unroll, args.n_steps, parallel_backward=pb)
    elif args.sweep == "alphas":
        for na in (6, 4, 3, 2):
            bench_point(f"a{na}", args.batch, args.max_outer, args.max_inner,
                        na, args.unroll, args.n_steps, parallel_backward=pb)
    elif args.sweep == "unroll":
        for ur in (8, 20, 40):
            bench_point(f"u{ur}", args.batch, args.max_outer, args.max_inner,
                        args.n_alphas, ur, args.n_steps, parallel_backward=pb)
    else:
        bench_point("point", args.batch, args.max_outer, args.max_inner,
                    args.n_alphas, args.unroll, args.n_steps,
                    parallel_backward=pb)

    if args.record and RESULTS:
        from mpc_tpu.utils import perfdb
        rec = {"config": f"{args.record_key}: config #2 profile "
                         f"(AL-iLQR N=40, sweep={args.sweep})",
               "source": f"examples/profile_config2.py --sweep {args.sweep}"}
        for row in RESULTS:
            rec[row["exp"]] = (
                f"{row['solves_per_s']} solves/s (p50 {row['p50_step_s']} s, "
                f"batch {row['batch']}, conv {row['converged_fraction']}, "
                f"outer {row['outer_mean']}/{row['outer_max']}, "
                f"inner {row['inner_mean']}/{row['inner_max']})")
        perfdb.record(args.record_key, rec)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

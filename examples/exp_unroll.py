"""Experiment: compile seconds and step time per horizon-scan unroll factor.

Times the headline closed loop (bench.py: Pacejka, N=12, batch 1024) and
config 2 (AL-iLQR, N=40, Bezier road, state constraints, batch 256) with
the horizon scans unrolled by each given factor.

Run from the repository root on the GPU:

    python examples/exp_unroll.py --headline 1,2,4,12 --config2 1,8

Prints one JSON line per variant. With ``--concurrent`` all variants are
compiled at once in a thread pool, and each one's compile seconds then
overlap the others' (an upper bound of a lone compile); steps are always
timed one variant at a time.
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


def headline_variant(unroll: int, batch: int = 1024):
    """``(name, jitted, args, n_lanes)`` of the headline closed-loop step."""
    from bench import build_headline

    step, ys, carries, _ = build_headline(batch, unroll=unroll)
    return f"headline_u{unroll}", step, (ys, carries), batch


def config2_variant(unroll: int, batch: int = 256, n_horiz: int = 40):
    """``(name, jitted, args, n_lanes)`` of config 2's closed-loop step."""
    from examples.bench_suite import config2_setup, config2_step

    cl, y0_fn = config2_setup()
    rng = np.random.default_rng(0)
    ys = jnp.asarray(np.stack([y0_fn(rng) for _ in range(batch)]))
    step, ctrl = config2_step(n_horiz, unroll=unroll)
    carries = jax.vmap(lambda _: ctrl.init_carry())(jnp.arange(batch))
    return f"config2_u{unroll}", step, (ys, carries, cl), batch


def time_steps(compiled, args, n_warm: int = 3, n_timed: int = 10):
    """Run the closed loop: (step seconds, converged fraction, finite)."""
    n_carry = 2   # (ys, carries) come back first; config 2 also takes cl
    state, rest = args[:n_carry], args[n_carry:]
    times, conv = [], []
    for i in range(n_warm + n_timed):
        t0 = time.perf_counter()
        out = compiled(*state, *rest)
        jax.block_until_ready(out[0])
        if i >= n_warm:
            times.append(time.perf_counter() - t0)
            conv.append(float(np.mean(np.asarray(out[2]))))
        state = out[:n_carry]
    finite = bool(np.isfinite(np.asarray(state[0])).all())
    return times, float(np.mean(conv)), finite


def report(name, lanes, compile_s, concurrent, times, conv, finite):
    p50 = float(np.percentile(times, 50))
    print(json.dumps({
        "variant": name, "compile_s": compile_s,
        "compiled_concurrently": concurrent, "step_p50_s": p50,
        "step_p99_s": float(np.percentile(times, 99)), "steps_s": times,
        "solves_per_s": lanes / p50, "converged_fraction": conv,
        "finite": finite}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--headline", default="",
                    help="comma-separated unroll factors for the headline")
    ap.add_argument("--config2", default="",
                    help="comma-separated unroll factors for config 2")
    ap.add_argument("--concurrent", action="store_true",
                    help="compile all variants at once")
    args = ap.parse_args()

    from chip_smoke import compile_concurrently, compile_timed
    from mpc_tpu.utils.compile_cache import enable_compile_cache
    from mpc_tpu.utils.perfdb import device_stamp

    enable_compile_cache()
    print(json.dumps({"device": device_stamp()}), flush=True)
    variants = ([headline_variant(int(u)) for u in args.headline.split(",")
                 if u]
                + [config2_variant(int(u)) for u in args.config2.split(",")
                   if u])
    programs = [(v[1], v[2]) for v in variants]
    if args.concurrent:
        compiled = compile_concurrently(programs)
    else:
        compiled = [compile_timed(jitted, *a) for jitted, a in programs]
    for (name, _, vargs, lanes), (comp, compile_s) in zip(variants,
                                                          compiled):
        report(name, lanes, compile_s, args.concurrent,
               *time_steps(comp, vargs))


if __name__ == "__main__":
    main()

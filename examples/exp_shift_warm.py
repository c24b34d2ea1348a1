"""Experiment: shifted vs verbatim warm starts (the RTI rotation trick).

Compares rotating the previous plan by one stage (through the
``warm_prep`` hook; the shift costs one roll per step) with reusing it
verbatim, counting PANOC iterations and failures. This is the source of the
warm-start note in control/mpc.py; ``--record`` stores the result through
utils/perfdb.

Run:  python examples/exp_shift_warm.py [--road straight|circle] [--record]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import circle_centerline, straight_centerline

PARAMS = VehicleParams()
RESULTS = {}


def run(name, ctrl, cl, n_sim=20, batch=64):
    f_d = discretize(pacejka_dynamics)
    rng = np.random.default_rng(0)
    y0s = np.zeros((batch, 6), np.float32)
    y0s[:, 0] = float(cl[0, 0])
    y0s[:, 1] = float(cl[0, 1]) + rng.uniform(-0.05, 0.05, batch)
    d0 = cl[1] - cl[0]
    y0s[:, 2] = float(jnp.arctan2(d0[1], d0[0]))
    y0s[:, 3] = rng.uniform(0.3, 1.0, batch)

    @jax.jit
    def step(ys, carries):
        def one(y, c):
            out = ctrl.step(c, {"y0": y, "p": PARAMS, "centerline": cl})
            return (f_d(y, out.u0, PARAMS), out.carry, out.result.converged)
        return jax.vmap(one)(ys, carries)

    carries = jax.vmap(lambda _: ctrl.init_carry())(jnp.arange(batch))
    ys = jnp.asarray(y0s)
    convs = []
    for _ in range(n_sim):
        ys, carries, conv = step(ys, carries)
        convs.append(float(jnp.mean(conv.astype(jnp.float32))))
    tot_it = float(jnp.mean(carries.tot_it))
    fails = float(jnp.mean(carries.failures))
    row = {"exp": name, "batch": batch, "n_sim": n_sim,
           "mean_total_inner_iters": round(tot_it, 1),
           "mean_failures": round(fails, 3),
           "mean_converged_fraction": round(float(np.mean(convs)), 4)}
    RESULTS[name] = row
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--roads", nargs="*", default=["straight", "circle"])
    ap.add_argument("--record", action="store_true")
    args = ap.parse_args()

    def shift(z, param, cold):
        # Rotate the input plan one stage forward, repeat the last stage.
        # Applied unconditionally: the vehicle OCP has m=0 constraints, so
        # the ``cold`` sentinel (all(sigma<=0)) is vacuously True every step
        # and gating on it would never shift; rotating the cold [1,0] tile
        # is itself a no-op, so unconditional is safe.
        del cold
        u = z.reshape(-1, 2)
        return jnp.concatenate([u[1:], u[-1:]], axis=0).reshape(-1)

    for road in args.roads:
        cl = (straight_centerline(100) if road == "straight"
              else circle_centerline(100))
        base = build_vehicle_controller(
            n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
            panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=300))
        run(f"{road}_verbatim", base, cl)
        shifted = dataclasses.replace(base, warm_prep=shift)
        run(f"{road}_shifted", shifted, cl)

    if args.record and RESULTS:
        from mpc_tpu.utils import perfdb
        rec = {"config": "11: shifted vs verbatim warm start "
                         "(RTI rotation trick, N=12, 20 steps)",
               "source": "examples/exp_shift_warm.py --record"}
        for name, row in RESULTS.items():
            rec[name] = (f"{row['mean_total_inner_iters']} mean inner iters, "
                         f"{row['mean_failures']} failures, conv "
                         f"{row['mean_converged_fraction']}")
        perfdb.record("11", rec)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

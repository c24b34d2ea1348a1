"""Benchmark: batched warm-started MPC solves/s on one GPU.

One "solve" = a complete warm-started ALM+PANOC trajectory optimization for
the Pacejka vehicle OCP (N_horiz=12, 24 decision vars, 100-point centerline
— the reference's configuration, main.py:65-70) to eps=1e-4 stationarity,
inside a closed loop with per-scenario plant propagation (plant ==
prediction model, main.py:145).

Run from the repository root:  python bench.py
Prints a detail line, then one JSON result line {"metric", "value", "unit"}
as the LAST line.
"""

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
from mpc_tpu.ops.road import straight_centerline

HEADLINE_BATCH = 1024
HEADLINE_N_HORIZ = 12


def build_headline(batch: int = HEADLINE_BATCH,
                   n_horiz: int = HEADLINE_N_HORIZ, unroll=None):
    """The headline closed loop: ``(mpc_step, y0s, carries0, single_step)``.

    ``mpc_step(ys, carries) -> (ys_next, carries_next, converged)`` is one
    jitted, vmapped warm-started controller step plus plant propagation over
    ``batch`` lanes; ``single_step`` is its batch-1 counterpart. Initial
    states are drawn from seed 0. ``unroll=None`` takes the library's
    horizon-unroll policy.
    """
    ctrl = build_vehicle_controller(
        n_horiz=n_horiz,
        alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=300),
        unroll=unroll,
    )
    params = VehicleParams()
    f_d = discretize(pacejka_dynamics)
    cl = straight_centerline(100)

    rng = np.random.default_rng(0)
    y0s = np.zeros((batch, 6), np.float32)
    y0s[:, 0] = rng.uniform(-0.1, 0.5, batch)
    y0s[:, 1] = rng.uniform(-0.1, 0.1, batch)
    y0s[:, 2] = rng.uniform(-0.2, 0.2, batch)
    y0s[:, 3] = rng.uniform(0.3, 1.0, batch)

    def one(y, carry):
        out = ctrl.step(carry, {"y0": y, "p": params, "centerline": cl})
        y_next = f_d(y, out.u0, params)
        return y_next, out.carry, out.result.converged

    mpc_step = jax.jit(jax.vmap(one))
    carries = jax.vmap(lambda _: ctrl.init_carry())(jnp.arange(batch))
    return mpc_step, jnp.asarray(y0s), carries, jax.jit(one)


def main():
    from mpc_tpu.utils.compile_cache import enable_compile_cache
    from mpc_tpu.utils.perfdb import device_stamp

    enable_compile_cache()
    batch = HEADLINE_BATCH
    n_steps = 20          # timed closed-loop steps
    n_warmup = 5

    mpc_step, y0s, carries0, mpc_step1 = build_headline(batch)
    ys, carries = y0s, carries0
    for _ in range(n_warmup):  # compile + reach warm-started steady state
        ys, carries, conv = mpc_step(ys, carries)
    jax.block_until_ready(ys)

    times = []
    conv_frac = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        ys, carries, conv = mpc_step(ys, carries)
        jax.block_until_ready(ys)
        times.append(time.perf_counter() - t0)
        conv_frac.append(float(jnp.mean(conv.astype(jnp.float32))))

    times = np.asarray(times)
    p50 = float(np.percentile(times, 50))
    solves_per_s = batch / p50

    # --- single-solve latency (batch=1), the real-time metric -------------
    # The reference's control interval is Ts = 0.05 s (car_dynamics.py:93):
    # one warm-started solve must fit that budget. Measured as a separate
    # batch-1 closed loop (NOT headline/batch divided by batch — dispatch
    # and worst-lane effects don't amortize at batch 1).
    y1 = y0s[0]
    c1 = jax.tree_util.tree_map(lambda x: x[0], carries0)
    for _ in range(n_warmup):
        y1, c1, _ = mpc_step1(y1, c1)
    jax.block_until_ready(y1)
    lat = []
    for _ in range(50):
        t0 = time.perf_counter()
        y1, c1, _ = mpc_step1(y1, c1)
        jax.block_until_ready(y1)
        lat.append(time.perf_counter() - t0)
    lat = np.asarray(lat)
    lat_p50 = float(np.percentile(lat, 50))

    print(json.dumps({
        "detail": {
            "batch": batch, "n_horiz": HEADLINE_N_HORIZ,
            "p50_step_latency_s": p50,
            "p99_step_latency_s": float(np.percentile(times, 99)),
            "mean_converged_fraction": float(np.mean(conv_frac)),
            "single_solve_p50_s": lat_p50,
            "single_solve_p99_s": float(np.percentile(lat, 99)),
            "realtime_budget_s": 0.05,   # Ts, car_dynamics.py:93
            "realtime_ok": bool(lat_p50 <= 0.05),
            "device": device_stamp(),
        }
    }))
    print(json.dumps({
        "metric": "mpc_solves_per_s_per_chip",
        "value": solves_per_s,
        "unit": "solves/s/chip",
    }))


if __name__ == "__main__":
    main()

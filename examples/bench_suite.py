"""Full benchmark suite: the five BASELINE.json configs on one chip.

Configs run one after another in one process, which holds the card for
the whole run (``--configs`` picks a subset). Each result is printed as one
JSON line and recorded through ``mpc_tpu.utils.perfdb``.

Run:  python examples/bench_suite.py [--quick] [--configs 1 2 3 4 5]
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
from mpc_tpu.control.event_triggered import EventTriggeredController
from mpc_tpu.control.mpc import build_vehicle_controller
from mpc_tpu.models.bicycle import pacejka_dynamics, simplified_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.bezier import bezier_centerline, lane_change_control_points
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.utils.timing import percentile_summary

PARAMS = VehicleParams()


def bench_mpc_config(name, ctrl, f_d, cl, y0_fn, batch, n_warm=4, n_steps=10):
    rng = np.random.default_rng(0)
    y0s = jnp.asarray(np.stack([y0_fn(rng) for _ in range(batch)]))

    @jax.jit
    def step(state):
        ys, carries = state

        def one(y, c):
            out = ctrl.step(c, {"y0": y, "p": PARAMS, "centerline": cl})
            return f_d(y, out.u0, PARAMS), out.carry, out.result.converged
        ys2, carries2, conv = jax.vmap(one)(ys, carries)
        return (ys2, carries2), conv

    carries = jax.vmap(lambda _: ctrl.init_carry())(jnp.arange(batch))
    state = (y0s, carries)
    for _ in range(n_warm):
        state, conv = step(state)
    jax.block_until_ready(state)
    ts, conv_frac = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, conv = step(state)
        jax.block_until_ready(state)
        ts.append(time.perf_counter() - t0)
        # per-step mean, averaged over ALL timed steps (bench.py
        # semantics) — a final-step sample misrepresents configs whose
        # per-step convergence varies
        conv_frac.append(float(jnp.mean(conv.astype(jnp.float32))))

    lat = percentile_summary(ts)
    return {
        "config": name,
        "batch": batch,
        "solves_per_s": round(batch / lat["p50"], 1),
        "p50_step_s": round(lat["p50"], 4),
        "p99_step_s": round(lat["p99"], 4),
        "converged_fraction": round(float(np.mean(conv_frac)), 4),
        # full per-step series: which steps carry the tail (cold outer
        # restarts vs steady warm steps) is visible, not just p50/p99
        "per_step_s": str([round(t, 3) for t in ts]),
        "per_step_conv": str([round(c, 4) for c in conv_frac]),
    }


def batch1_latency(ctrl, f_d, cl, y0, n_warm=5, n_steps=40, ts_budget=0.05):
    """Batch-1 closed-loop step latency vs the reference's Ts budget.

    Mirrors bench.py:86-122's real-time check (Ts = 0.05 s,
    reference: car_dynamics.py:93) for the non-headline configs: one
    warm-started solve per control interval, measured as its own batch-1
    loop (dispatch and worst-lane effects don't amortize at batch 1).
    """
    @jax.jit
    def step1(y, carry):
        out = ctrl.step(carry, {"y0": y, "p": PARAMS, "centerline": cl})
        return f_d(y, out.u0, PARAMS), out.carry

    y, c = jnp.asarray(y0), ctrl.init_carry()
    for _ in range(n_warm):
        y, c = step1(y, c)
    jax.block_until_ready(y)
    lat = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        y, c = step1(y, c)
        jax.block_until_ready(y)
        lat.append(time.perf_counter() - t0)
    s = percentile_summary(lat)
    return {
        "batch1_p50_s": round(s["p50"], 5),
        "batch1_p99_s": round(s["p99"], 5),
        "realtime_budget_s": ts_budget,
        "realtime_ok": bool(s["p50"] <= ts_budget),
    }


def run_config_1(args):
    B = 256 if args.quick else 1024
    ctrl1 = build_vehicle_controller(
        n_horiz=20, model="simplified", alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=20, max_iter=200))
    f_d1 = discretize(simplified_dynamics)

    def y0_1(rng):
        return np.array([0, rng.uniform(-0.05, 0.05), 0,
                         rng.uniform(0.2, 1.0)], np.float32)

    return bench_mpc_config("1: kinematic straight N=20", ctrl1, f_d1,
                            straight_centerline(100), y0_1, B)


def config2_setup():
    pts = lane_change_control_points(5.0).control_points * 0.01
    cl2 = bezier_centerline(pts, size=100)
    d0 = cl2[1] - cl2[0]
    hd = float(jnp.arctan2(d0[1], d0[0]))

    def y0_2(rng):
        return np.array([float(cl2[0, 0]), float(cl2[0, 1]) +
                         rng.uniform(-0.02, 0.02), hd,
                         rng.uniform(0.2, 0.8), 0, 0], np.float32)

    return cl2, y0_2


def config2_step(n_horiz: int = 40, unroll=None):
    """Config 2's jitted batch closed-loop step and its controller.

    ``step(ys, carries, cl) -> (ys, carries, converged, u0)`` vmaps one
    warm-started AL-iLQR controller step plus plant propagation over the
    lanes; ``unroll=None`` takes the library's horizon-unroll policy.
    """
    from mpc_tpu.control.mpc import build_vehicle_ilqr_controller
    from mpc_tpu.solver.ilqr import IlqrConfig
    ctrl = build_vehicle_ilqr_controller(
        n_horiz=n_horiz, bound_state_constraints=True,
        alm_cfg=AlmConfig(delta=1e-3, max_iter=8, sigma_0=1e3,
                          penalty_factor=5.0),
        ilqr_cfg=IlqrConfig(max_iter=30, unroll=unroll))
    f_d = discretize(pacejka_dynamics)
    params = VehicleParams()

    def one(y, carry, cl):
        out = ctrl.step(carry, {"y0": y, "p": params, "centerline": cl})
        return (f_d(y, out.u0, params), out.carry, out.result.converged,
                out.u0)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, None))), ctrl


def run_config_2(args):
    """Pacejka on Bezier road, N=40, bounded state constraints.

    Solved with AL-iLQR (the single/multiple-shooting/iLQR comparison is
    ``examples/exp_ms.py``) with the sequential Riccati backward pass
    (IlqrConfig default). Neither choice has been timed on the GPU yet.
    """
    from mpc_tpu.control.mpc import build_vehicle_ilqr_controller
    from mpc_tpu.solver.ilqr import IlqrConfig
    B = 128 if args.quick else 256
    cl2, y0_2 = config2_setup()
    ctrl2 = build_vehicle_ilqr_controller(
        n_horiz=40, bound_state_constraints=True,
        alm_cfg=AlmConfig(delta=1e-3, max_iter=8, sigma_0=1e3,
                          penalty_factor=5.0),
        ilqr_cfg=IlqrConfig(max_iter=30))
    f_d2 = discretize(pacejka_dynamics)
    out = bench_mpc_config("2: dynamic Bezier N=40 + state constr (AL-iLQR)",
                           ctrl2, f_d2, cl2, y0_2, B, n_steps=6)
    out["solver"] = "al-ilqr, sequential riccati backward"
    rng = np.random.default_rng(3)
    out.update(batch1_latency(ctrl2, f_d2, cl2, y0_2(rng)))
    return out


def run_config_3(args):
    base = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=300))
    f_d3 = discretize(pacejka_dynamics)
    etc = EventTriggeredController(base=base, f_d=f_d3, threshold=1e-2,
                                   eps=1e-4)
    cl3 = straight_centerline(100)
    B3 = 1024
    rng = np.random.default_rng(0)
    y0s = np.zeros((B3, 6), np.float32)
    y0s[:, 1] = rng.uniform(-0.1, 0.1, B3)
    y0s[:, 3] = rng.uniform(0.3, 1.0, B3)

    @jax.jit
    def etc_step(state):
        ys, carries = state

        def one(y, c):
            out = etc.step(c, {"y0": y, "p": PARAMS, "centerline": cl3})
            return f_d3(y, out.u0, PARAMS), out.carry, out.triggered
        ys2, c2, trig = jax.vmap(one)(ys, carries)
        return (ys2, c2), trig

    carries = jax.vmap(lambda _: etc.init_carry())(jnp.arange(B3))
    state = (jnp.asarray(y0s), carries)
    for _ in range(4):
        state, trig = etc_step(state)
    jax.block_until_ready(state)
    ts, trig_frac = [], []
    for _ in range(12):
        t0 = time.perf_counter()
        state, trig = etc_step(state)
        jax.block_until_ready(state)
        ts.append(time.perf_counter() - t0)
        trig_frac.append(float(jnp.mean(trig.astype(jnp.float32))))
    lat = percentile_summary(ts)
    return {
        "config": "3: event-triggered 1k states",
        "batch": B3,
        "steps_per_s_x_batch": round(B3 / lat["p50"], 1),
        "p50_step_s": round(lat["p50"], 4),
        "mean_trigger_fraction": round(float(np.mean(trig_frac)), 4),
    }


def run_config_4(args):
    """Two-car game-theoretic MPC (BASELINE config #4 wording): the coupled
    IBR-decision + per-car MPC closed loop of sim/two_car.py, batched over
    scenario pairs. The raw payoff kernel is kept as a secondary line.

    Fixture: the overtake geometry of tests/test_two_car.py:52-63 batched
    up — both cars start in lane 1 with B slow and close ahead of A, so the
    IBR layer must decide a lane change *during* the loop (a fixture that
    parks B in lane 2 sits at a frozen fixed point with no lane change)."""
    from mpc_tpu.models.params import VehicleParams  # noqa: F401
    from mpc_tpu.sim.two_car import make_two_car_game

    B = 64 if args.quick else 256
    n_sim = 10
    ctrl = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=150))
    f_d = discretize(pacejka_dynamics)
    run = make_two_car_game(ctrl, f_d, PARAMS, n_sim=n_sim)
    # both cars start in lane 1 (overtake setup)
    batched = jax.jit(jax.vmap(lambda ya, yb: run(ya, yb, 1, 1)))

    rng = np.random.default_rng(7)
    y0a = np.zeros((B, 6), np.float32)
    y0a[:, 1] = rng.uniform(-0.02, 0.02, B)
    y0a[:, 3] = rng.uniform(0.7, 1.0, B)            # fast ego, lane 1
    y0b = np.zeros((B, 6), np.float32)
    y0b[:, 0] = rng.uniform(0.08, 0.25, B)          # close ahead, same lane
    y0b[:, 1] = rng.uniform(-0.02, 0.02, B)
    y0b[:, 3] = rng.uniform(0.08, 0.2, B)           # slow leader
    y0a, y0b = jnp.asarray(y0a), jnp.asarray(y0b)

    out = batched(y0a, y0b)                          # compile + warm
    jax.block_until_ready(out.ys_a)
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = batched(y0a, y0b)
        jax.block_until_ready(out.ys_a)
        ts.append(time.perf_counter() - t0)
    wall = float(np.median(ts))
    assert np.isfinite(np.asarray(out.ys_a)).all()
    assert np.isfinite(np.asarray(out.ys_b)).all()

    # lane-change accounting includes the step-1 decision (initial lane 1)
    lanes_a = np.asarray(out.lanes_a)                # (B, n_sim)
    lanes_full = np.concatenate(
        [np.ones((B, 1), lanes_a.dtype), lanes_a], axis=1)
    changes = np.abs(np.diff(lanes_full, axis=1)) > 0
    kernel = _payoff_kernel_bench()
    return {
        "config": "4: two-car game-theoretic MPC (IBR + per-car MPC loop)",
        "batch_pairs": B, "n_sim": n_sim,
        "pair_steps_per_s": round(B * n_sim / wall, 1),
        "mpc_solves_per_s": round(2 * B * n_sim / wall, 1),
        "wall_s_per_loop": round(wall, 3),
        "mean_lane_changes_a": round(float(changes.mean()), 4),
        "pairs_with_lane_change": round(float(changes.any(axis=1).mean()), 4),
        "payoff_kernel_secondary": kernel,
    }


def _payoff_kernel_bench():
    from mpc_tpu.decision.game_theory import Cars, Ego, lane_payoffs_batched
    B4 = 4096
    rng = np.random.default_rng(1)
    egos = Ego(x=jnp.asarray(rng.uniform(-10, 10, B4), jnp.float32),
               v=jnp.asarray(rng.uniform(5, 20, B4), jnp.float32),
               lane=jnp.ones((B4,), jnp.int32))
    cars = Cars(
        x=jnp.asarray(rng.uniform(-50, 80, (B4, 4)), jnp.float32),
        v=jnp.asarray(rng.uniform(0, 20, (B4, 4)), jnp.float32),
        lane=jnp.asarray(rng.integers(1, 3, (B4, 4)), jnp.int32),
        mask=jnp.ones((B4, 4), bool))
    pay = jax.jit(lane_payoffs_batched)
    out = pay(egos, cars)
    jax.block_until_ready(out)
    ts = []
    for _ in range(20):
        t0 = time.perf_counter()
        out = pay(egos, cars)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    lat = percentile_summary(ts)
    return (f"{round(B4 / lat['p50'], 1)} decisions/s at batch {B4} "
            f"(p50 {round(lat['p50'], 5)} s)")


def run_config_5(args):
    """Randomized scenario suite, two-tier solving.

    The single-tier batched scan pays worst-lane iteration cost on every
    step. Two tiers: a cheap bounded-budget pass over the full batch, then
    a compacted straggler re-solve at full budget (sim/scenarios.py). The
    straggler batch is scattered back over a full repeat-padded index
    vector (static shapes) and every pad shape is compiled during warm-up,
    so no straggler count triggers a compile mid-rollout.
    """
    from mpc_tpu.io.native_scenarios import generate_scenarios
    from mpc_tpu.sim.scenarios import run_scenario_suite_two_tier
    B5 = 256 if args.quick else 2048
    n_sim5 = 10
    sc = generate_scenarios(seed=0, batch=B5, size=100)
    sc = sc._replace(y0=jnp.asarray(sc.y0),
                     centerline=jnp.asarray(sc.centerline),
                     obstacles=jnp.asarray(sc.obstacles))
    ctrl_full = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=150))
    ctrl_cheap = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=args.cheap_iters))
    f_d5 = discretize(pacejka_dynamics)
    # warm-up/compile pass (cheap batch shape + at least one straggler shape)
    run_scenario_suite_two_tier(ctrl_full, ctrl_cheap, f_d5, sc, PARAMS, 2)
    t0 = time.perf_counter()
    state, conv = run_scenario_suite_two_tier(ctrl_full, ctrl_cheap, f_d5, sc,
                                              PARAMS, n_sim5)
    dt = time.perf_counter() - t0
    st = state["stats"]
    out = {
        "config": "5: randomized scenario suite (two-tier)",
        "batch": B5, "n_sim": n_sim5,
        "cheap_max_iter": args.cheap_iters,
        "wall_s": round(dt, 3),
        "solves_per_s": round(B5 * n_sim5 / dt, 1),
        "converged_fraction": round(float(conv.mean()), 6),
        # per-step tier anatomy (VERDICT r4 task 1): where each step's wall
        # goes — cheap-tier solve, straggler re-solve, and the remainder
        # (host compaction/scatter + dispatch)
        "cheap_s_per_step": str([round(t, 2) for t in st["cheap_s"]]),
        "straggler_s_per_step": str([round(t, 2) for t in st["straggler_s"]]),
        "n_stragglers_per_step": str(st["n_stragglers"]),
    }
    # batch-1 real-time line on a representative scenario (same ctrl/OCP)
    out.update(batch1_latency(ctrl_full, f_d5, sc.centerline[0], sc.y0[0]))
    return out


CONFIGS = {"1": run_config_1, "2": run_config_2, "3": run_config_3,
           "4": run_config_4, "5": run_config_5}


def main():
    from mpc_tpu.utils import perfdb

    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS),
                    choices=list(CONFIGS))
    ap.add_argument("--cheap-iters", type=int, default=40,
                    help="config 5 cheap-tier PANOC iteration cap; lanes "
                         "that miss it are re-solved at full budget")
    args = ap.parse_args()

    for c in args.configs:
        r = CONFIGS[c](args)
        r["source"] = f"examples/bench_suite.py --configs {c}"
        print(json.dumps(r), flush=True)
        perfdb.record(c, r)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

"""Run the MPC main path once on the GPU and check what comes out.

Run from the repository root:

    python chip_smoke.py            # one GPU: phases 0-4
    python chip_smoke.py --multi    # four GPUs: the mesh-sharded phases only

Each phase prints one JSON line with its numbers and seconds. The last line,
printed only when every phase passed, is exactly
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a GPU the script exits non-zero before any phase runs; there is no
CPU fallback. The CPU backend serves only as the comparison side of phases 2
and 4, in the same process (one process opens the card once).

Phases (one GPU):
  0 device      platform must be "gpu"; card name and power limit.
  1 headline    bench.py's closed loop (Pacejka, N=12, batch 1024, the
                library's horizon unroll): cold and warm compile seconds,
                step p50/p99, converged fraction.
  2 closed_loop the reference's main.py flow (400 steps, one lane, solved to
                eps=1e-5) on the GPU and on the CPU: max abs state
                difference <= 1e-3.
  3 oracle      three f32 solves vs the f64 scipy oracle (the
                tests/test_ocp_parity.py gate and tolerances).
  4 al_ilqr     config 2 (AL-iLQR, N=40, Bezier road, state constraints,
                batch 256): first inputs of 8 lanes vs the CPU within 5e-3.
Phases (--multi, four GPUs):
  precompile     compiles the programs of the three mesh phases at once, one
                 thread each: their compile seconds (which overlap).
  scenario_mesh  sharded solve on a (4, 1) mesh vs one card, atol 1e-5.
  road_mesh      sequence-parallel road search on a (2, 2) mesh, atol 1e-4.
  horizon_mesh   horizon-sharded AL-iLQR step on a (2, 2) mesh, atol 1e-4.
  dryrun         __graft_entry__.dryrun_multichip(4).

Solves are traced at float32 HIGHEST matmul precision
(mpc_tpu/solver/precision.py); the tolerances above assume it. Every phase
after the headline keeps the horizon scans loops (unroll=1) on both sides of
its comparison: the check is of the numbers, and loops compile fastest.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.control.mpc import (build_vehicle_controller,
                                 build_vehicle_ilqr_controller,
                                 build_vehicle_ocp)
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.sim.closedloop import run_closed_loop_jit
from mpc_tpu.solver.alm import make_alm_solver
from mpc_tpu.solver.ilqr import IlqrConfig
from mpc_tpu.utils import f64_oracle
from mpc_tpu.utils.perfdb import gpu_name_and_power_limit

PARAMS = VehicleParams()
MULTI_COUNT = 4
# --multi sizes: the headline's horizon, batch and road on the scenario and
# road meshes; config 2's horizon and batch on the horizon mesh.
MESH_N_HORIZ = 12
SCENARIO_BATCH = 1024
ROAD_BATCH = 512
HORIZON_BATCH = 256
HORIZON_N = 40


class PhaseFailed(Exception):
    """A phase's check did not hold."""


def require(cond, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def compile_timed(jitted, *args):
    """Lower and compile ``jitted`` for ``args``: (compiled, seconds)."""
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def compile_concurrently(programs):
    """Compile every ``(jitted, args)``, one thread per XLA compile: a list
    of ``(compiled, seconds)``.

    Tracing and lowering hold the GIL, so they run one program at a time;
    each compile starts as soon as its program is lowered. A program's
    seconds run from the start of its lowering to the end of its compile,
    and overlap the others'.
    """
    def compile_lowered(lowered, t0):
        compiled = lowered.compile()
        return compiled, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=max(1, len(programs))) as ex:
        futures = []
        for jitted, args in programs:
            t0 = time.perf_counter()
            futures.append(ex.submit(compile_lowered, jitted.lower(*args),
                                     t0))
        return [f.result() for f in futures]


def all_finite(tree) -> bool:
    return all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree_util.tree_leaves(tree))


def final_line(devices) -> str:
    """The result line: exactly ``{"ok": true, "device": {...}}``."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


# ---------------------------------------------------------------------------
# one GPU
# ---------------------------------------------------------------------------

def phase_device(devices, min_count: int = 1) -> dict:
    d = devices[0]
    require(d.platform == "gpu",
            f"JAX found no GPU: the default platform is {d.platform!r}")
    require(len(devices) >= min_count,
            f"{len(devices)} GPUs, this run needs {min_count}")
    smi = gpu_name_and_power_limit()
    for line in smi:
        print(line, flush=True)
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices), "nvidia_smi": smi,
            "compile_cache_dir": jax.config.jax_compilation_cache_dir}


def phase_headline(batch: int = 1024, n_warm: int = 5, n_timed: int = 10,
                   min_converged: float = 0.99) -> dict:
    from bench import build_headline

    step, ys, carries, _ = build_headline(batch)
    compiled, cold_s = compile_timed(step, ys, carries)
    # Drop the in-memory caches: the second compile is served by the
    # persistent compilation cache when one is configured.
    jax.clear_caches()
    compiled, warm_s = compile_timed(step, ys, carries)

    for _ in range(n_warm):
        ys, carries, conv = compiled(ys, carries)
        require(all_finite(ys), "non-finite state in a warm-up step")
    times, conv_frac = [], []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        ys, carries, conv = compiled(ys, carries)
        jax.block_until_ready(ys)
        times.append(time.perf_counter() - t0)
        require(all_finite(ys), "non-finite state in a timed step")
        conv_frac.append(float(np.mean(np.asarray(conv))))
    mean_conv = float(np.mean(conv_frac))
    require(mean_conv >= min_converged,
            f"converged fraction {mean_conv} < {min_converged}")
    p50 = float(np.percentile(times, 50))
    return {"batch": batch, "n_horiz": 12,
            "compile_cold_s": cold_s, "compile_warm_s": warm_s,
            "step_p50_s": p50, "step_p99_s": float(np.percentile(times, 99)),
            "solves_per_s": batch / p50,
            "mean_converged_fraction": mean_conv}


def _reference_closed_loop(n_sim: int):
    """examples/vehicle_mpc.py's setup (reference main.py:62-152), solved to
    the parity gate's eps=1e-5.

    The longitudinal position on the straight road is an unregulated
    integrator: per-step solution differences add up along the 400 steps.
    At eps=1e-4 a rounding-level perturbation of the initial state (1e-7)
    alone moves x by up to 1.3e-3 on the CPU backend; at eps=1e-5 by 2e-4,
    under the 1e-3 gate.
    """
    ctrl = build_vehicle_controller(
        n_horiz=12, alm_cfg=AlmConfig(eps=1e-5),
        panoc_cfg=PanocConfig(lbfgs_memory=12, max_iter=300), unroll=1)
    run = run_closed_loop_jit(ctrl, discretize(pacejka_dynamics), n_sim)
    y0 = jnp.asarray([0.0, 0.0, 0.0, 0.5, 0.0, 0.0], jnp.float32)
    args = (y0, {"p": PARAMS, "centerline": straight_centerline(100)},
            PARAMS)
    return run, args


def phase_closed_loop(n_sim: int = 400, max_diff: float = 1e-3) -> dict:
    run, args = _reference_closed_loop(n_sim)
    compiled, compile_s = compile_timed(run, *args)
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    run_s = time.perf_counter() - t0

    # The same program on the CPU backend.
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        run_cpu, args_cpu = _reference_closed_loop(n_sim)
        t0 = time.perf_counter()
        out_cpu = jax.block_until_ready(
            run_cpu(*jax.device_put(args_cpu, cpu)))
        cpu_s = time.perf_counter() - t0

    ys, ys_cpu = np.asarray(out.ys), np.asarray(out_cpu.ys)
    require(all_finite(ys) and all_finite(ys_cpu), "non-finite closed loop")
    diff = float(np.max(np.abs(ys - ys_cpu)))
    require(diff <= max_diff, f"GPU vs CPU closed loop differ by {diff}")
    return {"n_sim": n_sim, "max_abs_state_diff": diff,
            "compile_s": compile_s, "run_s": run_s, "cpu_compile_run_s": cpu_s,
            "converged_fraction": float(np.mean(np.asarray(out.converged))),
            "cpu_converged_fraction":
                float(np.mean(np.asarray(out_cpu.converged))),
            "tot_it": int(out.carry.tot_it),
            "failures": int(out.carry.failures)}


def phase_oracle() -> dict:
    o = f64_oracle
    prob = build_vehicle_ocp(n_horiz=o.N_HORIZ, v_ref=o.V_REF, ts=o.TS,
                             weights=o.WEIGHTS, unroll=1)
    solve = jax.jit(make_alm_solver(
        prob, AlmConfig(eps=1e-5), PanocConfig(lbfgs_memory=12,
                                               max_iter=400)))
    u_init = jnp.tile(jnp.asarray([1.0, 0.0], jnp.float32), o.N_HORIZ)
    lam0 = jnp.zeros(prob.m, jnp.float32)
    cl, cl64 = straight_centerline(100), o.straight_centerline_f64()
    excess, du0 = [], []
    for y0 in o.PARITY_INITIAL_STATES:
        y0 = np.asarray(y0, np.float64)
        ref_x = o.lbfgsb_reference(y0, PARAMS, cl64)
        res = solve({"y0": jnp.asarray(y0, jnp.float32), "p": PARAMS,
                     "centerline": cl}, u_init, lam0)
        ours = np.asarray(res.u, np.float64)
        excess.append(float(o.np_cost(ours, y0, cl64, PARAMS)
                            - o.np_cost(ref_x, y0, cl64, PARAMS)))
        du0.append(float(np.max(np.abs(ours[:2] - ref_x[:2]))))
    require(max(excess) <= o.COST_TOL,
            f"f64 cost above the oracle's by {max(excess)}")
    require(max(du0) <= o.U0_ATOL, f"first input off by {max(du0)}")
    return {"cost_excess_vs_oracle": excess, "u0_max_abs_diff": du0,
            "cost_tol": o.COST_TOL, "u0_atol": o.U0_ATOL}


def phase_al_ilqr(batch: int = 256, n_horiz: int = 40, n_warm: int = 3,
                  n_timed: int = 5, n_compare: int = 8,
                  u0_atol: float = 5e-3) -> dict:
    from examples.bench_suite import config2_setup, config2_step

    cl, y0_fn = config2_setup()
    rng = np.random.default_rng(0)
    ys = jnp.asarray(np.stack([y0_fn(rng) for _ in range(batch)]))
    step, ctrl = config2_step(n_horiz, unroll=1)
    carries = jax.vmap(lambda _: ctrl.init_carry())(jnp.arange(batch))
    compiled, compile_s = compile_timed(step, ys, carries, cl)

    times, conv_frac = [], []
    for i in range(n_warm + n_timed):
        prev = (ys, carries)
        t0 = time.perf_counter()
        ys, carries, conv, u0 = compiled(ys, carries, cl)
        jax.block_until_ready(ys)
        if i >= n_warm:
            times.append(time.perf_counter() - t0)
            conv_frac.append(float(np.mean(np.asarray(conv))))
        require(all_finite(ys), "non-finite AL-iLQR closed-loop state")

    # The last step again on the CPU, from the same states and carries.
    cpu = jax.devices("cpu")[0]
    lanes = jax.tree_util.tree_map(lambda x: np.asarray(x[:n_compare]), prev)
    with jax.default_device(cpu):
        step_cpu, _ = config2_step(n_horiz, unroll=1)
        u0_cpu = step_cpu(*jax.device_put((*lanes, cl), cpu))[3]
    diff = float(np.max(np.abs(np.asarray(u0)[:n_compare]
                               - np.asarray(u0_cpu))))
    require(diff <= u0_atol, f"GPU vs CPU first inputs differ by {diff}")
    return {"batch": batch, "n_horiz": n_horiz, "compile_s": compile_s,
            "step_p50_s": float(np.percentile(times, 50)),
            "mean_converged_fraction": float(np.mean(conv_frac)),
            "u0_max_abs_diff_vs_cpu": diff, "lanes_compared": n_compare}


# ---------------------------------------------------------------------------
# four GPUs (--multi)
# ---------------------------------------------------------------------------

def _headline_inputs(batch: int, n_horiz: int):
    rng = np.random.default_rng(0)
    y0s = np.zeros((batch, 6), np.float32)
    y0s[:, 1] = rng.uniform(-0.1, 0.1, batch)
    y0s[:, 3] = rng.uniform(0.3, 1.0, batch)
    U0s = np.tile(np.asarray([1.0, 0.0], np.float32), (batch, n_horiz))
    lam0s = np.zeros((batch, 6 * n_horiz), np.float32)
    return (jnp.asarray(y0s), straight_centerline(100), PARAMS,
            jnp.asarray(U0s), jnp.asarray(lam0s))


def sharded_solver(devices, n_scenario: int, n_model: int, n_horiz: int):
    """The mesh-sharded batch solver of the --multi phases (unroll=1), one
    jitted object per mesh and horizon, so a program compiled by
    :func:`phase_precompile` is found again."""
    return _sharded_solver(tuple(devices), n_scenario, n_model, n_horiz)


@functools.lru_cache(maxsize=None)
def _sharded_solver(devices, n_scenario, n_model, n_horiz):
    from mpc_tpu.parallel.mesh import make_mesh
    from mpc_tpu.parallel.sharding import make_sharded_vehicle_solver

    mesh = make_mesh(n_scenario, n_model, devices=list(devices))
    return make_sharded_vehicle_solver(mesh, n_horiz=n_horiz, unroll=1)


def _sharded_vs_one_card(devices, n_scenario: int, n_model: int,
                         batch: int, n_horiz: int, atol: float) -> dict:
    args = _headline_inputs(batch, n_horiz)
    sharded = sharded_solver(devices, n_scenario, n_model, n_horiz)
    compiled, compile_s = compile_timed(sharded, *args)
    t0 = time.perf_counter()
    us, _, conv, _ = jax.block_until_ready(compiled(*args))
    solve_s = time.perf_counter() - t0

    # The one-card solve takes the lanes in chunks of one shard's size, so
    # each compiled program sees the same per-device shapes: XLA may
    # reassociate a lane's sums differently at another batch size.
    one = sharded_solver(devices[:1], 1, 1, n_horiz)
    y0s, cl, params, U0s, lam0s = args
    chunk = batch // n_scenario
    parts = [one(y0s[i:i + chunk], cl, params, U0s[i:i + chunk],
                 lam0s[i:i + chunk]) for i in range(0, batch, chunk)]
    us_1 = jnp.concatenate([p[0] for p in parts])
    conv_1 = jnp.concatenate([p[2] for p in parts])
    require(all_finite(us) and all_finite(us_1), "non-finite solution")
    diff = float(np.max(np.abs(np.asarray(us) - np.asarray(us_1))))
    require(diff <= atol, f"sharded vs one-card solve differ by {diff}")
    return {"mesh": [n_scenario, n_model], "batch": batch,
            "n_horiz": n_horiz, "compile_s": compile_s, "solve_s": solve_s,
            "max_abs_u_diff": diff, "atol": atol,
            "converged_fraction": float(np.mean(np.asarray(conv))),
            "one_card_converged_fraction":
                float(np.mean(np.asarray(conv_1)))}


def phase_scenario_mesh(devices, batch: int = SCENARIO_BATCH,
                        n_horiz: int = MESH_N_HORIZ) -> dict:
    return _sharded_vs_one_card(devices, len(devices), 1, batch, n_horiz,
                                atol=1e-5)


def phase_road_mesh(devices, batch: int = ROAD_BATCH,
                    n_horiz: int = MESH_N_HORIZ) -> dict:
    return _sharded_vs_one_card(devices, len(devices) // 2, 2, batch,
                                n_horiz, atol=1e-4)


def horizon_step(devices, n_scenario: int, n_horizon: int, batch: int,
                 n_horiz: int):
    """Config 2's batch-native AL-iLQR controller step on a horizon mesh
    (unroll=1): ``(step(carry, ys), carry0, ys)``, one per mesh and size."""
    return _horizon_step(tuple(devices), n_scenario, n_horizon, batch,
                         n_horiz)


@functools.lru_cache(maxsize=None)
def _horizon_step(devices, n_scenario, n_horizon, batch, n_horiz):
    from examples.bench_suite import config2_setup
    from mpc_tpu.parallel.mesh import make_horizon_mesh

    cl, y0_fn = config2_setup()
    rng = np.random.default_rng(0)
    ys = jnp.asarray(np.stack([y0_fn(rng) for _ in range(batch)]))
    ctrl = build_vehicle_ilqr_controller(
        n_horiz=n_horiz, bound_state_constraints=True,
        alm_cfg=AlmConfig(delta=1e-3, max_iter=8, sigma_0=1e3,
                          penalty_factor=5.0),
        ilqr_cfg=IlqrConfig(max_iter=30, unroll=1),
        mesh=make_horizon_mesh(n_scenario, n_horizon, devices=list(devices)))
    step = jax.jit(lambda c, y: ctrl.step(
        c, {"y0": y, "p": PARAMS, "centerline": cl}))
    return step, ctrl.init_carry(batch), ys


def phase_horizon_mesh(devices, batch: int = HORIZON_BATCH,
                       n_horiz: int = HORIZON_N, atol: float = 1e-4) -> dict:
    step, carry, ys = horizon_step(devices, len(devices) // 2, 2, batch,
                                   n_horiz)
    compiled, compile_s = compile_timed(step, carry, ys)
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(carry, ys))
    step_s = time.perf_counter() - t0
    step_1, carry_1, _ = horizon_step(devices[:1], 1, 1, batch, n_horiz)
    out_1 = step_1(carry_1, ys)
    require(all_finite(out.u0) and all_finite(out_1.u0), "non-finite step")
    diff = float(np.max(np.abs(np.asarray(out.u0) - np.asarray(out_1.u0))))
    require(diff <= atol, f"horizon-sharded vs one-card u0 differ by {diff}")
    return {"mesh": [len(devices) // 2, 2], "batch": batch,
            "n_horiz": n_horiz, "compile_s": compile_s, "step_s": step_s,
            "max_abs_u0_diff": diff, "atol": atol,
            "converged_fraction":
                float(np.mean(np.asarray(out.result.converged)))}


def phase_precompile(devices) -> dict:
    """Compile the programs of the three mesh phases, and their one-card
    references, at once."""
    n = len(devices)
    h_step, h_carry, h_ys = horizon_step(devices, n // 2, 2, HORIZON_BATCH,
                                         HORIZON_N)
    h1_step, h1_carry, _ = horizon_step(devices[:1], 1, 1, HORIZON_BATCH,
                                        HORIZON_N)
    programs = {
        "scenario_mesh": (sharded_solver(devices, n, 1, MESH_N_HORIZ),
                          _headline_inputs(SCENARIO_BATCH, MESH_N_HORIZ)),
        "road_mesh": (sharded_solver(devices, n // 2, 2, MESH_N_HORIZ),
                      _headline_inputs(ROAD_BATCH, MESH_N_HORIZ)),
        "horizon_mesh": (h_step, (h_carry, h_ys)),
        # one shard's lanes on one card: the reference of both solve meshes
        "one_card_solve": (sharded_solver(devices[:1], 1, 1, MESH_N_HORIZ),
                           _headline_inputs(SCENARIO_BATCH // n,
                                            MESH_N_HORIZ)),
        "one_card_horizon": (h1_step, (h1_carry, h_ys)),
    }
    t0 = time.perf_counter()
    done = compile_concurrently(list(programs.values()))
    return {"compile_s": {name: s for name, (_, s) in zip(programs, done)},
            "all_compiled_s": time.perf_counter() - t0}


def phase_dryrun(devices) -> dict:
    from __graft_entry__ import dryrun_multichip

    dryrun_multichip(len(devices))
    return {"n_devices": len(devices)}


def phases(multi: bool):
    """``(name, fn(devices) -> dict)`` in run order."""
    if multi:
        return [
            ("device", lambda d: phase_device(d, min_count=MULTI_COUNT)),
            ("precompile", phase_precompile),
            ("scenario_mesh", phase_scenario_mesh),
            ("road_mesh", phase_road_mesh),
            ("horizon_mesh", phase_horizon_mesh),
            ("dryrun", phase_dryrun),
        ]
    return [
        ("device", phase_device),
        ("headline", lambda d: phase_headline()),
        ("closed_loop", lambda d: phase_closed_loop()),
        ("oracle", lambda d: phase_oracle()),
        ("al_ilqr", lambda d: phase_al_ilqr()),
    ]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU mesh phases")
    args = ap.parse_args(argv)

    # Phases 2 and 4 compare with the CPU backend: keep it available when
    # JAX_PLATFORMS names only the GPU.
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")

    from mpc_tpu.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform == "gpu":
        enable_compile_cache()
    if args.multi:
        devices = devices[:MULTI_COUNT]
    for name, fn in phases(args.multi):
        t0 = time.perf_counter()
        try:
            out = fn(devices)
        except PhaseFailed as e:
            print(json.dumps({"phase": name, "ok": False, "error": str(e),
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
            return 1
        print(json.dumps({"phase": name, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    print(final_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Experiment: ALM warm-started penalties (config #2) + PANOC iteration
cost breakdown for the headline config.

Run on the GPU:  python examples/exp_warm_sigma.py
Prints one JSON line per experiment.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

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
from mpc_tpu.ops.bezier import bezier_centerline, lane_change_control_points
from mpc_tpu.ops.road import straight_centerline

PARAMS = VehicleParams()


def timed_steps(step, state, n_warm, n_steps):
    for _ in range(n_warm):
        state, aux = step(state)
    jax.block_until_ready(state)
    ts = []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, aux = step(state)
        jax.block_until_ready(state)
        ts.append(time.perf_counter() - t0)
    return state, aux, float(np.median(ts))


def bench_config2():
    """Config #2 (N=40, Pacejka, Bezier road, bounded state constraints)."""
    pts = lane_change_control_points(5.0).control_points * 0.01
    cl = bezier_centerline(pts, size=100)
    B = 256
    ctrl = build_vehicle_controller(
        n_horiz=40, bound_state_constraints=True,
        alm_cfg=AlmConfig(eps=1e-3, delta=1e-3, max_iter=8, eps_0=1e-2, sigma_0=1e3),
        panoc_cfg=PanocConfig(lbfgs_memory=40, max_iter=150))
    f_d = discretize(pacejka_dynamics)
    d0 = cl[1] - cl[0]
    hd = float(jnp.arctan2(d0[1], d0[0]))
    rng = np.random.default_rng(0)
    y0s = np.stack([
        np.array([float(cl[0, 0]), float(cl[0, 1]) + rng.uniform(-0.02, 0.02),
                  hd, rng.uniform(0.2, 0.8), 0, 0], np.float32)
        for _ in range(B)])

    @jax.jit
    def step(state):
        ys, carries = state

        def one(y, c):
            out = ctrl.step(c, {"y0": y, "p": PARAMS, "centerline": cl})
            return f_d(y, out.u0, PARAMS), out.carry, \
                (out.result.converged, out.result.outer_iterations,
                 out.result.inner_iterations)
        ys2, carries2, aux = jax.vmap(one)(ys, carries)
        return (ys2, carries2), aux

    carries = jax.vmap(lambda _: ctrl.init_carry())(jnp.arange(B))
    state, aux, p50 = timed_steps(step, (jnp.asarray(y0s), carries), 4, 6)
    conv, outer, inner = aux
    print(json.dumps({
        "exp": "config2_warm_sigma", "batch": B,
        "solves_per_s": round(B / p50, 1),
        "p50_step_s": round(p50, 4),
        "converged_fraction": round(float(jnp.mean(conv.astype(jnp.float32))), 4),
        "mean_outer": round(float(jnp.mean(outer.astype(jnp.float32))), 2),
        "mean_inner": round(float(jnp.mean(inner.astype(jnp.float32))), 1),
    }), flush=True)


def bench_iteration_cost():
    """Headline config (N=12 Pacejka, straight road): separate the cost of the
    raw candidate-fan evaluation from the full PANOC iteration."""
    B = 1024
    n_horiz = 12
    ctrl = build_vehicle_controller(
        n_horiz=n_horiz, alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=300))
    cl = straight_centerline(100)
    rng = np.random.default_rng(0)
    y0s = np.zeros((B, 6), np.float32)
    y0s[:, 1] = rng.uniform(-0.1, 0.1, B)
    y0s[:, 3] = rng.uniform(0.3, 1.0, B)
    y0s = jnp.asarray(y0s)
    Us = jnp.tile(jnp.tile(jnp.asarray([1.0, 0.0], jnp.float32), n_horiz)[None],
                  (B, 1))

    cost = ctrl.problem.cost
    # raw candidate-fan eval: 5 candidates x B lanes, value+grad (per-iteration load)
    n_cand = 5

    @jax.jit
    def fan_eval(Us, y0s):
        def per_lane(u, y):
            cands = jnp.stack([u + 0.001 * (i + 1) for i in range(n_cand)])
            vg = jax.vmap(jax.value_and_grad(cost), in_axes=(0, None))
            psis, grads = vg(cands, {"y0": y, "p": PARAMS, "centerline": cl})
            return psis, grads
        return jax.vmap(per_lane)(Us, y0s)

    out = fan_eval(Us, y0s)
    jax.block_until_ready(out)
    ts = []
    for _ in range(30):
        t0 = time.perf_counter()
        out = fan_eval(Us, y0s)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    t_fan = float(np.median(ts))

    # full solver at two iteration caps -> marginal per-iteration cost.
    # The batched while_loop runs until every lane exits, so the wall-clock
    # iteration count is the MAX over lanes; divide by that.
    def solver_time(max_iter):
        c = build_vehicle_controller(
            n_horiz=n_horiz, alm_cfg=AlmConfig(eps=1e-9),  # never converges
            panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=max_iter))

        @jax.jit
        def run(Us, y0s):
            def one(u, y):
                r = c.solve({"y0": y, "p": PARAMS, "centerline": cl},
                            u, jnp.zeros((c.problem.m,)))
                return r.psi, r.inner_iterations
            return jax.vmap(one)(Us, y0s)

        psi, it = run(Us, y0s)
        jax.block_until_ready(psi)
        ts = []
        for _ in range(10):
            t0 = time.perf_counter()
            psi, it = run(Us, y0s)
            jax.block_until_ready(psi)
            ts.append(time.perf_counter() - t0)
        return float(np.median(ts)), int(jnp.max(it))

    t20, it20 = solver_time(20)
    t120, it120 = solver_time(120)
    per_iter = (t120 - t20) / max(it120 - it20, 1)
    print(json.dumps({
        "exp": "iteration_cost", "batch": B,
        "fan_eval_ms": round(t_fan * 1e3, 3),
        "solver_20it_ms": round(t20 * 1e3, 2),
        "solver_120it_ms": round(t120 * 1e3, 2),
        "wall_iters": [it20, it120],
        "per_iter_ms": round(per_iter * 1e3, 3),
        "fan_fraction_of_iter": round(t_fan / per_iter, 3) if per_iter > 0 else None,
    }), flush=True)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    bench_config2()
    bench_iteration_cost()

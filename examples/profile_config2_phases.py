"""Phase-level profile of the AL-iLQR inner iteration (config #2 shape).

The black-box sweep (profile_config2.py --sweep iters) prices one masked
inner iteration as a whole. This times the three phases of one iteration in isolation — per-stage
Gauss-Newton derivatives, the Riccati backward pass (parallel scan vs
sequential), and the line-search forward fan — by reconstructing them from
the same public pieces ``solver/ilqr.py`` composes (same math, checked
against IlqrConfig defaults; drift risk is acceptable for a profile).

Run:  python examples/profile_config2_phases.py [--batch 256] [--record]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import functools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np

from mpc_tpu.control.mpc import STATE_CONSTRAINT_OFFSETS
from mpc_tpu.models.bicycle import pacejka_dynamics
from mpc_tpu.models.integrators import discretize
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.bezier import bezier_centerline, lane_change_control_points
from mpc_tpu.ops.costs import DEFAULT_VEHICLE_WEIGHTS, vehicle_stage_residuals
from mpc_tpu.solver.ilqr import IlqrConfig
from mpc_tpu.solver.lqr import lqt_solve_parallel, lqt_solve_sequential

PARAMS = VehicleParams()
N = 40
SD, ID = 6, 2
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)
OFFS = jnp.asarray(STATE_CONSTRAINT_OFFSETS, jnp.float32)
U_LO = jnp.asarray([-PARAMS.max_drive, -PARAMS.max_steer], jnp.float32)
U_HI = -U_LO

f_d = discretize(pacejka_dynamics)


def fr_k(x, u, lam_k, sigma_k, cl):
    xn = f_d(x, u, PARAMS)
    r = vehicle_stage_residuals(xn, u, cl, 1.0, DEFAULT_VEHICLE_WEIGHTS)
    g = xn ** 2 - OFFS
    zeta = g + lam_k / sigma_k
    zhat = jnp.clip(zeta, -jnp.inf, 0.0)
    r_al = jnp.sqrt(0.5 * sigma_k) * (zeta - zhat)
    return xn, jnp.concatenate([r, r_al])


def l_k(x, u, lam_k, sigma_k, cl):
    return jnp.sum(fr_k(x, u, lam_k, sigma_k, cl)[1] ** 2)


def derivatives(xs, us, lam, sigma, cl):
    def one(x, u, lam_k, sigma_k):
        (A, B), (Jx, Ju) = jax.jacfwd(
            lambda x_, u_: fr_k(x_, u_, lam_k, sigma_k, cl),
            argnums=(0, 1))(x, u)
        r = fr_k(x, u, lam_k, sigma_k, cl)[1]
        return (A, B, 2.0 * Jx.T @ Jx, 2.0 * Jx.T @ r,
                2.0 * Ju.T @ Ju, 2.0 * Ju.T @ r, 2.0 * Ju.T @ Jx)
    return jax.vmap(one)(xs[:-1], us, lam, sigma)


def backward(xs, us, lam, sigma, cl, reg, parallel=True):
    A, B, Q, q, R, r, P = derivatives(xs, us, lam, sigma, cl)
    Rr = R + reg * jnp.eye(ID, dtype=xs.dtype)
    lqt = lqt_solve_parallel if parallel else lqt_solve_sequential
    c = jnp.zeros((N, SD), xs.dtype)
    sol = lqt(jnp.zeros((SD,), xs.dtype), A, B, c, Q, q, Rr, r,
              jnp.zeros((SD, SD), xs.dtype), jnp.zeros((SD,), xs.dtype), P=P)
    return sol.Ko, sol.ko


def backward_only(A, B, Q, q, R, r, P, reg, parallel=True):
    Rr = R + reg * jnp.eye(ID, dtype=A.dtype)
    # sequential timed at the shipped configuration (IlqrConfig.unroll)
    lqt = lqt_solve_parallel if parallel \
        else functools.partial(lqt_solve_sequential,
                               unroll=IlqrConfig().unroll)
    c = jnp.zeros((N, SD), A.dtype)
    sol = lqt(jnp.zeros((SD,), A.dtype), A, B, c, Q, q, Rr, r,
              jnp.zeros((SD, SD), A.dtype), jnp.zeros((SD,), A.dtype), P=P)
    return sol.Ko, sol.ko


def forward_fan(y0, xs, us, Ks, kos, lam, sigma, cl, unroll=8):
    def roll(alpha):
        def step(x, inp):
            x_nom, u_nom, K, ko, lam_k, sigma_k = inp
            u = jnp.clip(u_nom - alpha * ko
                         - (K @ (x - x_nom)[..., None])[..., 0], U_LO, U_HI)
            xn = f_d(x, u, PARAMS)
            return xn, (xn, u, l_k(x, u, lam_k, sigma_k, cl))
        _, (xs_t, us_n, ls) = jax.lax.scan(
            step, y0, (xs[:-1], us, Ks, kos, lam, sigma), unroll=unroll)
        return xs_t, us_n, jnp.sum(ls)
    return jax.vmap(roll)(jnp.asarray(ALPHAS, jnp.float32))


def rollout(y0, us, lam, sigma, cl, unroll=8):
    def step(x, inp):
        u, lam_k, sigma_k = inp
        # clamp for BOTH dynamics and cost, as the real solver does
        # (solver/ilqr.py rollout: l_k(x, clamp(u), k))
        uc = jnp.clip(u, U_LO, U_HI)
        xn = f_d(x, uc, PARAMS)
        return xn, (xn, l_k(x, uc, lam_k, sigma_k, cl))
    _, (xs_t, ls) = jax.lax.scan(step, y0, (us, lam, sigma), unroll=unroll)
    return xs_t, jnp.sum(ls)


def timeit(fn, *args, reps=10):
    out = fn(*args)
    jax.block_until_ready(out)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--record", action="store_true")
    ap.add_argument("--record-key", default="9-phases")
    args = ap.parse_args()
    B = args.batch

    pts = lane_change_control_points(5.0).control_points * 0.01
    cl = bezier_centerline(pts, size=100)
    rng = np.random.default_rng(0)
    y0 = jnp.asarray(np.stack([np.array(
        [float(cl[0, 0]), float(cl[0, 1]) + rng.uniform(-0.02, 0.02),
         0.0, rng.uniform(0.2, 0.8), 0, 0], np.float32) for _ in range(B)]))
    us = jnp.asarray(rng.uniform(-0.1, 0.1, (B, N, ID)).astype(np.float32))
    us = us.at[..., 0].add(1.0)
    lam = jnp.zeros((B, N, 6), jnp.float32)
    sigma = jnp.full((B, N, 6), 1e3, jnp.float32)
    reg = jnp.full((B,), 1e-3, jnp.float32)

    roll_j = jax.jit(jax.vmap(functools.partial(rollout, unroll=8),
                              in_axes=(0, 0, 0, 0, None)))
    xs_t, _ = roll_j(y0, us, lam, sigma, cl)
    xs = jnp.concatenate([y0[:, None], xs_t], axis=1)

    deriv_j = jax.jit(jax.vmap(derivatives, in_axes=(0, 0, 0, 0, None)))
    A, Bm, Q, q, R, r, P = deriv_j(xs, us, lam, sigma, cl)

    bwd_par_j = jax.jit(jax.vmap(
        functools.partial(backward_only, parallel=True),
        in_axes=(0, 0, 0, 0, 0, 0, 0, 0)))
    bwd_seq_j = jax.jit(jax.vmap(
        functools.partial(backward_only, parallel=False),
        in_axes=(0, 0, 0, 0, 0, 0, 0, 0)))
    Ks, kos = bwd_par_j(A, Bm, Q, q, R, r, P, reg)

    fan_j = jax.jit(jax.vmap(functools.partial(forward_fan, unroll=8),
                             in_axes=(0, 0, 0, 0, 0, 0, 0, None)))
    fan40_j = jax.jit(jax.vmap(functools.partial(forward_fan, unroll=40),
                               in_axes=(0, 0, 0, 0, 0, 0, 0, None)))

    row = {"exp": "phases", "batch": B, "n_horiz": N}
    row["rollout_ms"] = round(timeit(roll_j, y0, us, lam, sigma, cl) * 1e3, 2)
    row["derivatives_ms"] = round(
        timeit(deriv_j, xs, us, lam, sigma, cl) * 1e3, 2)
    row["backward_parallel_ms"] = round(
        timeit(bwd_par_j, A, Bm, Q, q, R, r, P, reg) * 1e3, 2)
    row["backward_sequential_ms"] = round(
        timeit(bwd_seq_j, A, Bm, Q, q, R, r, P, reg) * 1e3, 2)
    row["forward_fan6_u8_ms"] = round(
        timeit(fan_j, y0, xs, us, Ks, kos, lam, sigma, cl) * 1e3, 2)
    row["forward_fan6_u40_ms"] = round(
        timeit(fan40_j, y0, xs, us, Ks, kos, lam, sigma, cl) * 1e3, 2)
    row["iteration_sum_ms"] = round(
        row["derivatives_ms"] + row["backward_parallel_ms"]
        + row["forward_fan6_u8_ms"], 2)
    print(json.dumps(row), flush=True)

    if args.record:
        from mpc_tpu.utils import perfdb
        rec = {"config": "9-phases: config #2 inner-iteration phase profile "
                         f"(batch {B}, N={N})",
               "source": "examples/profile_config2_phases.py --record"}
        rec.update({k: v for k, v in row.items() if k.endswith("_ms")})
        perfdb.record(args.record_key, rec)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

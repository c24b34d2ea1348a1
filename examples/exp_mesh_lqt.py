"""Horizon-mesh LQT scaling on the virtual 8-device CPU mesh.

Companion to examples/exp_mesh_scaling.py (scenario axis): times the
blocked associative-scan Riccati (parallel/lqr_sharded.py) with the
HORIZON axis sharded 1/2/4/8 ways at a long horizon — the cross-device
long-context axis of SURVEY.md §2.19/§5. Same honest caveat: the box has
2 physical cores, so the ceiling is ~2x; the signal is that the blocked
scan's collective overhead (one all_gather of chunk products per scan)
stays negligible as shards are added, i.e. the program *scales*.

Run:  python examples/exp_mesh_lqt.py [--batch 4] [--horizon 512] [--record]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import argparse
import json
import time

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mpc_tpu.parallel.lqr_sharded import make_lqt_horizon_sharded  # noqa: E402
from mpc_tpu.parallel.mesh import make_horizon_mesh  # noqa: E402


def _random_lqt(rng, Bb, N, n=6, m=2):
    def psd(head, d, scale):
        M = rng.normal(0, scale, (*head, d, d)).astype(np.float32)
        return M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(d, dtype=np.float32)

    A = (np.eye(n, dtype=np.float32)
         + 0.1 * rng.normal(0, 1, (Bb, N, n, n)).astype(np.float32) / n)
    B = rng.normal(0, 0.4, (Bb, N, n, m)).astype(np.float32)
    c = rng.normal(0, 0.05, (Bb, N, n)).astype(np.float32)
    Q = psd((Bb, N), n, 0.3)
    q = rng.normal(0, 0.2, (Bb, N, n)).astype(np.float32)
    R = psd((Bb, N), m, 0.3) + np.eye(m, dtype=np.float32)
    r = rng.normal(0, 0.2, (Bb, N, m)).astype(np.float32)
    QN = psd((), n, 0.3)
    qN = rng.normal(0, 0.2, n).astype(np.float32)
    x0 = rng.normal(0, 0.3, (Bb, n)).astype(np.float32)
    return tuple(map(jnp.asarray, (x0, A, B, c, Q, q, R, r, QN, qN)))


def bench(n_h, batch, N, n_reps=10):
    mesh = make_horizon_mesh(n_scenario=1, n_horizon=n_h,
                             devices=jax.devices()[:n_h])
    solve = jax.jit(make_lqt_horizon_sharded(mesh))
    args = _random_lqt(np.random.default_rng(0), batch, N)
    out = solve(*args)
    jax.block_until_ready(out.us)
    ts = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        out = solve(*args)
        jax.block_until_ready(out.us)
        ts.append(time.perf_counter() - t0)
    p50 = float(np.median(ts))
    assert np.all(np.isfinite(np.asarray(out.us)))
    return {"horizon_shards": n_h, "batch": batch, "N": N,
            "p50_s": round(p50, 4),
            "solves_per_s": round(batch / p50, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--horizon", type=int, default=512)
    ap.add_argument("--shards", nargs="*", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--record", action="store_true")
    args = ap.parse_args()

    rows = []
    for n_h in args.shards:
        row = bench(n_h, args.batch, args.horizon)
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.record:
        from mpc_tpu.utils import perfdb
        base = rows[0]["p50_s"]
        rec = {"config": "6-lqt: horizon-mesh blocked-scan Riccati scaling "
                         "(CPU stand-in, 2 physical cores)",
               "source": "examples/exp_mesh_lqt.py --record",
               "note": f"N={args.horizon}, batch {args.batch}; 8 virtual "
                       "CPU devices, physical ceiling ~2x — validates the "
                       "horizon-axis sharded program scales (all_gather "
                       "carry exchange stays negligible)"}
        for row in rows:
            rec[f"{row['horizon_shards']}_shards"] = (
                f"p50 {row['p50_s']} s (speedup x{base / row['p50_s']:.2f})")
        perfdb.record("6-lqt", rec)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

"""Virtual-mesh scenario-axis scaling: solves/s at 1..8 mesh devices.

BASELINE names the north-star measured at "1 chip, 1 host, >=2 hosts". Real
multi-chip hardware is unavailable here, so this records the scenario-DP
scaling curve on the virtual 8-device CPU mesh
(``--xla_force_host_platform_device_count=8``) — an honest stand-in that
validates the sharded program *scales* (the box has only 2 physical cores,
so the ceiling is ~2x; the interesting signal is that adding mesh devices
does not add overhead and the collective-free scenario axis parallelizes).

Run:  python examples/exp_mesh_scaling.py [--batch 256] [--record]
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

from mpc_tpu.config import AlmConfig, PanocConfig  # noqa: E402
from mpc_tpu.models.params import VehicleParams  # noqa: E402
from mpc_tpu.ops.road import straight_centerline  # noqa: E402
from mpc_tpu.parallel.mesh import make_mesh  # noqa: E402
from mpc_tpu.parallel.sharding import make_sharded_vehicle_solver  # noqa: E402

PARAMS = VehicleParams()


def bench_mesh(n_dev, batch, n_horiz=12, n_reps=5):
    mesh = make_mesh(n_scenario=n_dev, n_model=1,
                     devices=jax.devices()[:n_dev])
    solve_batch = make_sharded_vehicle_solver(
        mesh, n_horiz=n_horiz,
        alm_cfg=AlmConfig(eps=1e-4),
        panoc_cfg=PanocConfig(lbfgs_memory=n_horiz, max_iter=60))

    rng = np.random.default_rng(0)
    y0s = np.zeros((batch, 6), np.float32)
    y0s[:, 1] = rng.uniform(-0.1, 0.1, batch)
    y0s[:, 3] = rng.uniform(0.3, 1.0, batch)
    cl = straight_centerline(100)
    U0s = jnp.tile(jnp.tile(jnp.asarray([1.0, 0.0], jnp.float32), n_horiz),
                   (batch, 1))
    lam0s = jnp.zeros((batch, 6 * n_horiz), jnp.float32)
    y0s = jnp.asarray(y0s)

    out = solve_batch(y0s, cl, PARAMS, U0s, lam0s)
    jax.block_until_ready(out)
    ts = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        out = solve_batch(y0s, cl, PARAMS, U0s, lam0s)
        jax.block_until_ready(out)
        ts.append(time.perf_counter() - t0)
    p50 = float(np.median(ts))
    conv = float(jnp.mean(out[2].astype(jnp.float32)))
    return {"devices": n_dev, "batch": batch,
            "solves_per_s": round(batch / p50, 1),
            "p50_s": round(p50, 4), "converged_fraction": round(conv, 4)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--devices", nargs="*", type=int, default=[1, 2, 4, 8])
    ap.add_argument("--record", action="store_true")
    args = ap.parse_args()

    rows = []
    for n in args.devices:
        row = bench_mesh(n, args.batch)
        rows.append(row)
        print(json.dumps(row), flush=True)

    if args.record:
        from mpc_tpu.utils import perfdb
        base = rows[0]["solves_per_s"]
        rec = {"config": "6: virtual-mesh scenario-DP scaling "
                         "(CPU stand-in, 2 physical cores)",
               "source": "examples/exp_mesh_scaling.py --record",
               "note": "8 virtual CPU devices; physical ceiling ~2x — "
                       "validates sharded-program scaling shape, not "
                       "real-chip throughput (BASELINE 1-chip/1-host "
                       "matrix stand-in)"}
        for row in rows:
            rec[f"{row['devices']}_devices"] = (
                f"{row['solves_per_s']} solves/s "
                f"(speedup x{row['solves_per_s'] / base:.2f}, "
                f"conv {row['converged_fraction']})")
        perfdb.record("6", rec)


if __name__ == "__main__":
    from mpc_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()

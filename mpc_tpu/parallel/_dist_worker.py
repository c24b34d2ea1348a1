"""Multi-process worker for the jax.distributed integration test.

Run as ``python -m mpc_tpu.parallel._dist_worker <port> <pid> <nproc> <out>``
— one process per simulated host (CPU backend, 4 virtual devices
per process). Exercises the real multi-process path the single-process tests
cannot: ``jax.distributed.initialize`` (coordinator handshake), a global
mesh spanning both processes' devices, ``make_array_from_process_local_data``
(each process feeds only its local scenario shard — the cross-host data
path), a sharded batched solve, and a cross-process allgather of the result.

Process 0 writes the gathered solutions to ``out`` (.npy); the parent test
compares them against a single-process solve of the same problems
(tests/test_distributed.py). SURVEY.md §5 'distributed comms backend' row;
BASELINE.md 'measured at ... >=2 hosts'.
"""

import os
import sys


def main() -> None:
    port, pid, nproc, out = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                             sys.argv[4])
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4")
    import jax
    jax.config.update("jax_platforms", "cpu")

    from mpc_tpu.parallel.distributed import (initialize, local_batch_slice,
                                              pod_mesh)
    initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=nproc,
               process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc
    assert len(jax.local_devices()) == 4

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpc_tpu.config import AlmConfig, PanocConfig
    from mpc_tpu.parallel.mesh import SCENARIO_AXIS
    from mpc_tpu.solver.alm import make_alm_solver
    from mpc_tpu.solver.problem import Box, Problem

    # box QP: min 0.5||u - t||^2 over [-1,1]^4 -> solution clip(t)
    n, B = 4, 16

    def cost(u, t):
        return 0.5 * jnp.sum((u - t) ** 2)

    prob = Problem(cost=cost, constraints=None,
                   C=Box(-jnp.ones(n), jnp.ones(n)),
                   D=Box.unbounded(0), n=n, m=0)
    solve = make_alm_solver(prob, AlmConfig(eps=1e-5),
                            PanocConfig(lbfgs_memory=4, max_iter=100))

    mesh = pod_mesh()
    assert mesh.devices.size == 4 * nproc

    # deterministic global problem set; each process hosts only its shard
    ts_global = np.linspace(-2.0, 2.0, B * n).reshape(B, n).astype(np.float32)
    sharding = NamedSharding(mesh, P(SCENARIO_AXIS))
    ts = jax.make_array_from_process_local_data(
        sharding, ts_global[local_batch_slice(B)], ts_global.shape)

    @jax.jit
    def batch(ts):
        return jax.vmap(lambda t: solve(t, jnp.zeros(n), jnp.zeros(0)))(ts)

    res = batch(ts)
    from jax.experimental import multihost_utils
    u_all = multihost_utils.process_allgather(res.u, tiled=True)
    conv_all = multihost_utils.process_allgather(res.converged, tiled=True)
    assert u_all.shape == (B, n)
    if pid == 0:
        np.savez(out, u=np.asarray(u_all), converged=np.asarray(conv_all),
                 ts=ts_global)
    multihost_utils.sync_global_devices("done")
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()

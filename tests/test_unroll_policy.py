"""The horizon-scan unroll policy: loops on the CPU, ``GPU_UNROLL`` (capped
at the scan length) on a GPU, and an explicit ``unroll`` always wins."""

import jax
import jax.numpy as jnp
import pytest

from mpc_tpu.control.mpc import build_vehicle_ocp
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.solver import problem as problem_mod
from mpc_tpu.solver.ilqr import IlqrConfig, resolve_unroll
from mpc_tpu.solver.multiple_shooting import build_ms_ocp_problem
from mpc_tpu.solver.problem import Box, default_unroll


def _scan_unrolls(fn, *args):
    """The ``unroll`` of every scan in ``fn``'s jaxpr, nested ones too."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "scan":
                found.append(eqn.params["unroll"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


@pytest.fixture
def on_gpu(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")


def _vehicle_cost_unrolls(n_horiz, **kw):
    prob = build_vehicle_ocp(n_horiz=n_horiz, **kw)
    param = {"y0": jnp.zeros(6).at[3].set(0.5), "p": VehicleParams(),
             "centerline": straight_centerline(100)}
    return _scan_unrolls(prob.cost, jnp.zeros(prob.n), param)


def test_cpu_keeps_loops():
    assert default_unroll(12) == 1
    assert _vehicle_cost_unrolls(6) == [1]


@pytest.mark.parametrize("n_steps", [1, 3, 12, 40])
def test_gpu_unroll_capped_at_scan_length(on_gpu, n_steps):
    assert default_unroll(n_steps) == max(1, min(n_steps,
                                                 problem_mod.GPU_UNROLL))


@pytest.mark.parametrize("gpu_unroll", [1, 4, 12])
def test_single_shooting_builder_takes_policy(on_gpu, monkeypatch,
                                             gpu_unroll):
    monkeypatch.setattr(problem_mod, "GPU_UNROLL", gpu_unroll)
    assert _vehicle_cost_unrolls(6) == [min(6, gpu_unroll)]


def test_explicit_unroll_wins(on_gpu, monkeypatch):
    monkeypatch.setattr(problem_mod, "GPU_UNROLL", 4)
    assert _vehicle_cost_unrolls(6, unroll=1) == [1]
    assert _vehicle_cost_unrolls(6, unroll=3) == [3]
    assert resolve_unroll(IlqrConfig(unroll=2), 40) == 2


@pytest.mark.parametrize("backend,expected", [("cpu", 1), ("gpu", 5)])
def test_ilqr_config_none_takes_policy(monkeypatch, backend, expected):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    monkeypatch.setattr(problem_mod, "GPU_UNROLL", 5)
    assert resolve_unroll(IlqrConfig(), 40) == expected


def test_multiple_shooting_caps_at_segment_length(on_gpu, monkeypatch):
    monkeypatch.setattr(problem_mod, "GPU_UNROLL", 8)
    n_horiz, n_segments = 12, 4      # segments of 3 steps

    def f_d(x, u, p):
        return x + 0.1 * u

    def stage_cost(x, u, p):
        return jnp.sum(x ** 2) + jnp.sum(u ** 2)

    prob, _ = build_ms_ocp_problem(f_d, stage_cost, n_horiz, n_segments, 2,
                                   2, Box.unbounded(2 * n_horiz))
    unrolls = _scan_unrolls(prob.cost, jnp.zeros(prob.n),
                            {"y0": jnp.ones(2), "p": None})
    assert unrolls and set(unrolls) == {3}

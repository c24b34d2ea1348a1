"""Every solver family traces its contractions at float32 HIGHEST precision.

On GPUs a DEFAULT-precision f32 ``dot_general`` may run in TF32; the
solvers pin HIGHEST through ``solver/precision.py``. Each case lowers one
controller step (or solve) on the CPU and reads the precision of every
``stablehlo.dot_general`` in the program text.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_tpu.config import AlmConfig, PanocConfig
from mpc_tpu.models.params import VehicleParams
from mpc_tpu.ops.road import straight_centerline
from mpc_tpu.solver.ilqr import IlqrConfig
from mpc_tpu.solver.precision import pinned_precision

PARAMS = VehicleParams()
N = 4
ALM = AlmConfig(eps=1e-3, max_iter=2)
PANOC = PanocConfig(lbfgs_memory=4, max_iter=5)

_DOT = re.compile(r"stablehlo\.dot_general[^\n]*")


def dot_precisions(lowered_text: str) -> list:
    """The ``precision = [...]`` of every dot_general, in program order."""
    out = []
    for line in _DOT.findall(lowered_text):
        m = re.search(r"precision = \[([A-Z_]+), ([A-Z_]+)\]", line)
        out.append(m.groups() if m else ("DEFAULT", "DEFAULT"))
    return out


def _vehicle_param(batch=None):
    y0 = jnp.asarray([0.0, 0.0, 0.0, 0.5, 0.0, 0.0], jnp.float32)
    if batch is not None:
        y0 = jnp.tile(y0, (batch, 1))
    return {"y0": y0, "p": PARAMS, "centerline": straight_centerline(20)}


def _controller_step(ctrl):
    return (lambda c, prm: ctrl.step(c, prm)), (ctrl.init_carry(),
                                                _vehicle_param())


def case_panoc():
    from mpc_tpu.control.mpc import build_vehicle_controller
    return _controller_step(build_vehicle_controller(
        n_horiz=N, alm_cfg=ALM, panoc_cfg=PANOC))


def case_alm_constrained():
    from mpc_tpu.control.mpc import build_vehicle_controller
    return _controller_step(build_vehicle_controller(
        n_horiz=N, bound_state_constraints=True, alm_cfg=ALM,
        panoc_cfg=PANOC))


def case_al_ilqr():
    from mpc_tpu.control.mpc import build_vehicle_ilqr_controller
    return _controller_step(build_vehicle_ilqr_controller(
        n_horiz=N, bound_state_constraints=True, alm_cfg=ALM,
        ilqr_cfg=IlqrConfig(max_iter=3)))


def case_ilqr_parallel_scan():
    from mpc_tpu.control.mpc import build_vehicle_ilqr_controller
    return _controller_step(build_vehicle_ilqr_controller(
        n_horiz=N, alm_cfg=ALM,
        ilqr_cfg=IlqrConfig(max_iter=3, parallel_backward=True)))


def case_ilqr_horizon_mesh():
    from mpc_tpu.control.mpc import build_vehicle_ilqr_controller
    from mpc_tpu.parallel.mesh import make_horizon_mesh
    mesh = make_horizon_mesh(1, 2, devices=jax.devices()[:2])
    ctrl = build_vehicle_ilqr_controller(
        n_horiz=N, bound_state_constraints=True, alm_cfg=ALM,
        ilqr_cfg=IlqrConfig(max_iter=3), mesh=mesh)
    return (lambda c, prm: ctrl.step(c, prm)), (ctrl.init_carry(2),
                                                _vehicle_param(batch=2))


def case_multiple_shooting():
    from mpc_tpu.control.mpc import build_vehicle_ms_controller
    ctrl, _ = build_vehicle_ms_controller(
        n_horiz=N, n_segments=2, alm_cfg=AlmConfig(eps=1e-3, max_iter=2),
        panoc_cfg=PANOC)
    return _controller_step(ctrl)


def case_chain():
    from mpc_tpu.control.chain_mpc import (build_chain_controller,
                                           floor_coefficients)
    from mpc_tpu.models.chain import ChainSpec
    from mpc_tpu.models.params import ChainParams
    spec = ChainSpec(n_balls=3, dim=2)
    ctrl = build_chain_controller(spec, n_horiz=N, alm_cfg=ALM,
                                  panoc_cfg=PANOC)
    coeff, _ = floor_coefficients()
    param = {"y0": jnp.asarray(spec.initial_state()), "p": ChainParams(),
             "constr": jnp.asarray(coeff)}
    return (lambda c, prm: ctrl.step(c, prm)), (ctrl.init_carry(), param)


def case_scenario_mesh():
    from mpc_tpu.parallel.mesh import make_mesh
    from mpc_tpu.parallel.sharding import make_sharded_vehicle_solver
    mesh = make_mesh(2, 1, devices=jax.devices()[:2])
    solve = make_sharded_vehicle_solver(mesh, n_horiz=N, centerline_size=20,
                                        alm_cfg=ALM, panoc_cfg=PANOC)
    U0 = jnp.tile(jnp.asarray([1.0, 0.0], jnp.float32), (2, N))
    return solve, (_vehicle_param(batch=2)["y0"], straight_centerline(20),
                   PARAMS, U0, jnp.zeros((2, 6 * N), jnp.float32))


def case_lqr_solvers():
    from mpc_tpu.solver.lqr import lqt_solve_parallel, lqt_solve_sequential
    n, m = 3, 2
    rng = np.random.default_rng(0)
    args = tuple(jnp.asarray(a, jnp.float32) for a in (
        rng.normal(size=n), np.eye(n) + 0.1 * rng.normal(size=(N, n, n)),
        rng.normal(size=(N, n, m)), np.zeros((N, n)),
        np.broadcast_to(np.eye(n), (N, n, n)), np.zeros((N, n)),
        np.broadcast_to(np.eye(m), (N, m, m)), np.zeros((N, m)),
        np.eye(n), np.zeros(n)))
    return (lambda *a: (lqt_solve_sequential(*a), lqt_solve_parallel(*a)),
            args)


CASES = {f.__name__[5:]: f for f in (
    case_panoc, case_alm_constrained, case_al_ilqr, case_ilqr_parallel_scan,
    case_ilqr_horizon_mesh, case_multiple_shooting, case_chain,
    case_scenario_mesh, case_lqr_solvers)}


@pytest.mark.parametrize("family", list(CASES))
def test_solver_contractions_are_highest(family):
    fn, args = CASES[family]()
    text = jax.jit(fn).lower(*args).as_text()
    precs = dot_precisions(text)
    assert precs, f"{family}: no dot_general traced"
    assert all(p == ("HIGHEST", "HIGHEST") for p in precs), (
        family, sorted(set(precs)))


def test_unpinned_contraction_keeps_default():
    # The control case: outside the wrapper the global default (DEFAULT)
    # still holds, so the package changes no global config.
    x = jnp.ones((3, 3), jnp.float32)
    plain = jax.jit(lambda a: a @ a).lower(x).as_text()
    pinned = jax.jit(pinned_precision(lambda a: a @ a)).lower(x).as_text()
    assert dot_precisions(plain) == [("DEFAULT", "DEFAULT")]
    assert dot_precisions(pinned) == [("HIGHEST", "HIGHEST")]

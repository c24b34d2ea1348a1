"""Typed configuration for the whole framework.

The reference hardcodes every constant at call sites (solver params:
controller.py:27-48; model params: main.py:83-111; horizon/loop sizes:
main.py:65-70). Here a single set of frozen dataclasses carries them;
defaults equal the reference's literals for behavioral parity.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PanocConfig:
    """Inner PANOC(+L-BFGS) solver configuration.

    Defaults mirror alpaqa's ``StructuredPANOCLBFGSSolver`` setup at
    controller.py:27-37: stop criterion = ProjGradNorm2, max 1000 iterations,
    L-BFGS memory = N_horiz (set per-problem). Wall-clock caps (max_time
    0.2 s, controller.py:30) have no place inside a compiled device loop; the
    static iteration cap plays that role.
    """
    max_iter: int = 1000
    lbfgs_memory: int = 12
    alpha: float = 0.95              # gamma = alpha / L
    # Line-search grid over the homotopy x(tau) = u - (1-tau) r + tau d.
    # All grid points are evaluated in ONE batched value_and_grad call (data
    # parallel on the device) instead of alpaqa's sequential halving loop; the
    # forward-backward fallback (tau=0) is always included, preserving the
    # global convergence guarantee.
    taus: tuple = (1.0, 0.25, 1.0 / 16.0, 1.0 / 64.0)
    gamma_min: float = 1e-12
    max_gamma_backtracks: int = 60   # implicit via gamma_min; kept for clarity
    # Trust-region cap on the L-BFGS direction: ||d|| <= tr_mult * ||r||.
    # A healthy quasi-Newton direction scales with the residual times the
    # Hessian conditioning; directions far beyond that come from f32-noise
    # curvature pairs and the parallel line search's FBE merit is not
    # trustworthy that far from the iterate (solver/panoc.py).
    tr_mult: float = 1e5
    # Noise floor for L-BFGS curvature pairs: a pair whose step norm is
    # below lbfgs_min_step_mult * eps_f32 * (1 + ||u||) is f32 rounding
    # noise, not curvature (rho = 1/(s.y) explodes on it); skipped in
    # lbfgs_push. 0 (default) disables: the tr_mult direction cap already
    # contains noise-poisoned directions, and rejecting near-floor pairs
    # was measured to cost 3.4x worst-lane iterations on the warm-started
    # headline bench (fine steady-state refinements ARE near the floor).
    lbfgs_min_step_mult: float = 0.0
    # The ProjGradNorm2 criterion ||r||/gamma has an f32 rounding floor of
    # ~eps_f32*||u||/gamma. A lane that exits via the stagnation/plateau
    # path (iterates stopped moving, or the criterion stopped improving for
    # plateau_iters iterations) while within crit_floor_mult times that
    # floor is counted converged (solver/panoc.py). Set 0 to disable.
    crit_floor_mult: float = 4.0
    # Exit a lane whose best criterion has not improved for this many
    # consecutive iterations — a stiff f32 lane otherwise spins at max_iter
    # chasing a tolerance below the representable floor.
    plateau_iters: int = 40
    # Opt-in per-iterate history (psi, ||r||/gamma, gamma) in fixed-size
    # buffers — the batch-friendly replacement for alpaqa's streaming
    # progress callback (controller.py:23-24,38). Off by default: it adds a
    # (max_iter,) x3 buffer per lane.
    trace: bool = False


@dataclasses.dataclass(frozen=True)
class AlmConfig:
    """Outer augmented-Lagrangian loop configuration.

    Defaults mirror controller.py:39-48: eps=1e-6 (inner stationarity),
    delta=1e-4 (constraint satisfaction), Sigma_0=1e5 (initial penalty),
    max 1000 outer iterations (we default far lower — ALM converges in a
    handful of rounds and the cap is a static loop bound on the device).
    """
    eps: float = 1e-6                # final inner tolerance (stationarity)
    delta: float = 1e-4              # constraint violation tolerance
    # Initial penalty. The reference's 1e5 (an f64 number) is kept as the
    # default for parity, but in f32 prefer ~1e2..1e3 on problems whose AL
    # actually binds: at sigma ~ 1e5 the AL evaluation noise reaches the
    # QUB margin and the criterion ||r||/gamma hits its representable floor.
    sigma_0: float = 1e5
    max_iter: int = 20
    eps_0: float = 1e-1              # initial inner tolerance
    rho_eps: float = 1e-1            # inner tolerance shrink factor per outer iter
    penalty_factor: float = 10.0     # Sigma multiplier on insufficient progress
    theta: float = 0.25              # required violation decrease factor
    sigma_max: float = 1e9
    lam_max: float = 1e9
    # Opt-in per-outer-iteration history (psi, violation, eps_k, max sigma,
    # inner iterations); see PanocConfig.trace for the inner analogue.
    trace: bool = False


@dataclasses.dataclass(frozen=True)
class MpcConfig:
    """Vehicle MPC configuration (reference: main.py:65-70,112)."""
    n_horiz: int = 12
    ts: float = 0.05
    v_ref: float = 1.0
    centerline_size: int = 100
    n_sim: int = 400

"""Randomized scenario suites — generation and end-to-end rollout.

BASELINE.json config #5: 10k randomized road/obstacle scenarios rolled out
end to end. The reference has no scenario machinery at all
(its roads are two hardcoded centerlines, main.py:11-22); this module
generates batches of randomized roads (straight / arc / Bezier lane-change)
and initial states on device with jax.random, and rolls the whole suite
through the batched MPC closed loop — per-scenario centerlines included
(each lane of the vmap carries its own road).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from mpc_tpu.control.mpc import MpcController
from mpc_tpu.ops.bezier import lane_change_control_points
from mpc_tpu.sim.closedloop import ClosedLoopOut, run_closed_loop


class ScenarioBatch(NamedTuple):
    y0: jnp.ndarray           # (B, 6) initial states
    centerline: jnp.ndarray   # (B, size, 2) per-scenario roads
    obstacles: jnp.ndarray    # (B, K, 4) obstacle [x, y, phi, v]


def _random_straight(key, size):
    k1, k2, k3 = jax.random.split(key, 3)
    heading = jax.random.uniform(k1, (), minval=-0.5, maxval=0.5)
    offset = jax.random.uniform(k2, (2,), minval=-0.5, maxval=0.5)
    spacing = jax.random.uniform(k3, (), minval=0.05, maxval=0.15)
    s = jnp.arange(size) * spacing
    d = jnp.stack([jnp.cos(heading), jnp.sin(heading)])
    return offset + s[:, None] * d


def _random_arc(key, size):
    k1, k2, k3 = jax.random.split(key, 3)
    radius = jax.random.uniform(k1, (), minval=2.0, maxval=8.0)
    span = jax.random.uniform(k2, (), minval=1.5, maxval=2 * jnp.pi)
    sign = jnp.where(jax.random.bernoulli(k3), 1.0, -1.0)
    theta = jnp.linspace(0.0, span, size) * sign
    # start at origin heading +x: circle center at (0, radius*sign)
    x = radius * jnp.sin(theta)
    y = sign * radius * (1.0 - jnp.cos(theta))
    return jnp.stack([x, y], axis=1)


def _random_lane_change(key, size):
    k1, k2 = jax.random.split(key)
    i = jax.random.uniform(k1, (), minval=1.0, maxval=10.0)
    scale = jax.random.uniform(k2, (), minval=0.005, maxval=0.02)
    path = lane_change_control_points(i)
    # reference lane-change geometry is road-scale (meters, lane 3.75 m);
    # scale down to the 1:43 RC-car world
    pts = path.control_points * scale
    t = jnp.linspace(0.0, 1.0, size)
    from mpc_tpu.ops.bezier import bezier_curve
    return bezier_curve(t, pts)


def random_scenarios(key, batch: int, size: int = 100,
                     n_obstacles: int = 2) -> ScenarioBatch:
    """Generate a batch of randomized scenarios on device."""
    keys = jax.random.split(key, batch)

    def one(k):
        k_road, k_kind, k_state, k_obs = jax.random.split(k, 4)
        kind = jax.random.randint(k_kind, (), 0, 3)
        cl = jax.lax.switch(kind, [
            lambda: _random_straight(k_road, size),
            lambda: _random_arc(k_road, size),
            lambda: _random_lane_change(k_road, size),
        ])
        ks = jax.random.split(k_state, 4)
        # start near the road's first segment, moving forward
        d0 = cl[1] - cl[0]
        heading = jnp.arctan2(d0[1], d0[0])
        lateral = jax.random.uniform(ks[0], (), minval=-0.05, maxval=0.05)
        normal = jnp.stack([-d0[1], d0[0]]) / jnp.linalg.norm(d0)
        pos = cl[0] + normal * lateral
        v0 = jax.random.uniform(ks[1], (), minval=0.2, maxval=1.0)
        dpsi = jax.random.uniform(ks[2], (), minval=-0.2, maxval=0.2)
        y0 = jnp.stack([pos[0], pos[1], heading + dpsi, v0,
                        jnp.zeros(()), jnp.zeros(())])
        # obstacles scattered along the road
        oi = jax.random.randint(k_obs, (n_obstacles,), size // 4, size - 1)
        opos = cl[oi]
        obs = jnp.concatenate([
            opos, jnp.zeros((n_obstacles, 1)),
            jax.random.uniform(k_obs, (n_obstacles, 1), minval=0.0,
                               maxval=0.5)], axis=1)
        return y0, cl, obs

    y0, cl, obs = jax.vmap(one)(keys)
    return ScenarioBatch(y0=y0, centerline=cl, obstacles=obs)


def run_scenario_suite(controller: MpcController, f_d, scenarios: ScenarioBatch,
                       params, n_sim: int) -> ClosedLoopOut:
    """Roll every scenario end-to-end: vmap of the scan closed loop, each
    lane carrying its own centerline (and, when the controller's OCP has the
    obstacle field term, its own obstacle set — BASELINE config #5's
    'road/obstacle scenarios')."""
    if controller.problem.uses_obstacles:
        def one(y0, cl, obs):
            return run_closed_loop(
                controller, f_d, y0,
                {"p": params, "centerline": cl, "obstacles": obs},
                n_sim, params)
        return jax.jit(jax.vmap(one))(scenarios.y0, scenarios.centerline,
                                      scenarios.obstacles)

    def one(y0, cl):
        return run_closed_loop(controller, f_d, y0,
                               {"p": params, "centerline": cl}, n_sim, params)

    return jax.jit(jax.vmap(one))(scenarios.y0, scenarios.centerline)


# jitted two-tier step functions, cached across run_scenario_suite_two_tier
# calls: a fresh ``@jax.jit`` closure per call made every warm-up useless —
# the timed run re-traced and re-compiled both tiers from scratch. Keyed by
# object identity; the cached closures
# hold strong references to their key objects, so the ids stay valid.
# Bounded (LRU, newest-last dict order): the pinned controller/params
# objects and their compiled executables would otherwise accumulate without
# eviction in a long-lived process sweeping many controller configs.
_TWO_TIER_CACHE: dict = {}
_TWO_TIER_CACHE_MAX = 4


def _two_tier_steppers(controller, controller_cheap, f_d, params):
    key = (id(controller), id(controller_cheap), id(f_d), id(params))
    if key in _TWO_TIER_CACHE:
        _TWO_TIER_CACHE[key] = _TWO_TIER_CACHE.pop(key)   # mark recently used
        return _TWO_TIER_CACHE[key]
    use_obs = controller.problem.uses_obstacles

    def _param(y, cl, obs):
        param = {"y0": y, "p": params, "centerline": cl}
        if use_obs:
            param["obstacles"] = obs
        return param

    @jax.jit
    def cheap_step(ys, carries, cls, obss):
        def one(y, carry, cl, obs):
            out = controller_cheap.step(carry, _param(y, cl, obs))
            return f_d(y, out.u0, params), out.carry, out.result.converged
        return jax.vmap(one)(ys, carries, cls, obss)

    @jax.jit
    def full_step(ys, carries, cls, obss):
        def one(y, carry, cl, obs):
            out = controller.step(carry, _param(y, cl, obs))
            return f_d(y, out.u0, params), out.carry, out.result.converged
        return jax.vmap(one)(ys, carries, cls, obss)

    while len(_TWO_TIER_CACHE) >= _TWO_TIER_CACHE_MAX:
        del _TWO_TIER_CACHE[next(iter(_TWO_TIER_CACHE))]  # evict oldest
    _TWO_TIER_CACHE[key] = (cheap_step, full_step)
    return cheap_step, full_step


def run_scenario_suite_two_tier(controller: MpcController,
                                controller_cheap: MpcController, f_d,
                                scenarios: ScenarioBatch, params, n_sim: int,
                                straggler_pad: int = 64,
                                precompile_shapes: bool = True):
    """Suite rollout with two-tier solving to kill worst-lane variance.

    A batched ``lax.scan`` closed loop runs every lane in lockstep: each MPC
    step costs the MAX iteration count over the batch, so on randomized
    scenarios a handful of hard lanes tax every easy lane. Two tiers:

    1. *cheap pass* — one batched step through ``controller_cheap`` (same
       OCP, low iteration caps): bounded wall-clock per step;
    2. *straggler pass* — lanes whose cheap solve failed are compacted on
       host into a dense batch (padded to ``straggler_pad`` to bound
       recompilation shapes) and re-solved through ``controller`` (full
       budget), then scattered back.

    With ~1-5% stragglers the full-budget program runs on a 64-lane batch
    instead of 2048, so the expensive tail no longer multiplies by the
    batch. Returns ``(state, conv)`` like the resumable suite: final plant
    states + carries, and the (B, n_sim) per-step convergence after both
    tiers; ``state["stats"]`` carries per-step wall-clock for each tier and
    straggler counts (the profile that sizes the tiers). Both controllers
    must share the same Problem structure.
    """
    import time

    import numpy as np

    b = scenarios.y0.shape[0]
    carry0 = jax.vmap(lambda _: controller.init_carry())(jnp.arange(b))
    cheap_step, full_step = _two_tier_steppers(controller, controller_cheap,
                                               f_d, params)

    if precompile_shapes:
        # Pre-compile the WHOLE straggler code path (gathers + full-tier
        # step + scatters) for every pad shape this suite can hit
        # (straggler_pad * 2^j up to b): a first-seen pad shape otherwise
        # pays its compiles (the full-tier program and the eager
        # gather/scatter kernels) DURING the rollout. Idempotent across
        # calls: jit caches per shape.
        k = straggler_pad
        while True:
            idx_j = jnp.asarray(np.arange(k) % b)
            sel = lambda a: jax.tree_util.tree_map(lambda x: x[idx_j], a)
            ys_r, car_r, _ = full_step(sel(scenarios.y0), sel(carry0),
                                       scenarios.centerline[idx_j],
                                       scenarios.obstacles[idx_j])
            ys_sc = scenarios.y0.at[idx_j].set(ys_r)
            car_sc = jax.tree_util.tree_map(
                lambda d, s: d.at[idx_j].set(s), carry0, car_r)
            jax.block_until_ready((ys_sc, car_sc))
            if k >= b:
                break
            k *= 2

    ys = scenarios.y0
    carries = carry0
    obss = scenarios.obstacles
    cls = scenarios.centerline
    convs = []
    stats = {"cheap_s": [], "straggler_s": [], "n_stragglers": []}
    for _ in range(n_sim):
        prev_carries = carries
        t0 = time.perf_counter()
        ys2, carries, conv = cheap_step(ys, carries, cls, obss)
        # np.asarray of a JAX array is a read-only view; copy before the
        # in-place straggler update below.
        conv_np = np.array(conv)
        stats["cheap_s"].append(time.perf_counter() - t0)
        bad = np.flatnonzero(~conv_np)
        stats["n_stragglers"].append(int(bad.size))
        t0 = time.perf_counter()
        if bad.size:
            # pad the straggler batch to a fixed grid of sizes so the full
            # solver compiles for at most log(b/straggler_pad) shapes
            k = straggler_pad
            while k < bad.size:
                k *= 2
            idx = np.resize(bad, k)                     # repeat-pad
            idx_j = jnp.asarray(idx)
            sel = lambda a: jax.tree_util.tree_map(lambda x: x[idx_j], a)
            ys_r, car_r, conv_r = full_step(
                sel(ys), sel(prev_carries), cls[idx_j], obss[idx_j])
            # Scatter back ALL k padded lanes at the k-shaped index vector:
            # repeat-pad duplicates of a lane carry identical solve results
            # (deterministic batched program), so duplicate .at[].set
            # writes agree. Slicing to the genuine bad.size lanes instead
            # would create bad.size-SHAPED gather/scatter programs — a
            # fresh compile for every straggler count never seen before.
            scatter = lambda dst, src: jax.tree_util.tree_map(
                lambda d, s: d.at[idx_j].set(s), dst, src)
            ys2 = ys2.at[idx_j].set(ys_r)
            carries = scatter(carries, car_r)
            conv_np[bad] = np.asarray(conv_r)[: bad.size]
            jax.block_until_ready(ys2)
        stats["straggler_s"].append(time.perf_counter() - t0)
        ys = ys2
        convs.append(conv_np)
    return ({"ys": ys, "carries": carries, "stats": stats},
            np.stack(convs, axis=1))


def run_scenario_suite_resumable(controller: MpcController, f_d,
                                 scenarios: ScenarioBatch, params,
                                 n_sim: int, segment: int = 50,
                                 checkpoint_path: Optional[str] = None):
    """Chunked suite rollout with checkpoint/resume between segments.

    For large 10k-rollout runs (SURVEY.md §5 checkpoint/resume row): the
    closed loop advances ``segment`` steps per compiled call; after each
    segment the full suite state (plant states + warm-start carries + step
    index) is written atomically, and an interrupted run resumes from the
    last checkpoint.
    """
    import numpy as np
    from mpc_tpu.utils.checkpoint import load_checkpoint, save_checkpoint

    b = scenarios.y0.shape[0]
    carry0 = jax.vmap(lambda _: controller.init_carry())(jnp.arange(b))
    state = {"ys": scenarios.y0, "carries": carry0}
    step0 = 0
    if checkpoint_path is not None and _exists(checkpoint_path):
        state, step0 = load_checkpoint(checkpoint_path, state)
        state = jax.tree_util.tree_map(jnp.asarray, state)

    use_obs = controller.problem.uses_obstacles

    @jax.jit
    def run_segment(ys, carries, cls, obss):
        def one(y, carry, cl, obs):
            def scan_step(sc, _):
                y_, c_ = sc
                param = {"y0": y_, "p": params, "centerline": cl}
                if use_obs:
                    param["obstacles"] = obs
                out = controller.step(c_, param)
                return (f_d(y_, out.u0, params), out.carry), out.result.converged
            (y2, c2), conv = jax.lax.scan(scan_step, (y, carry), None,
                                          length=segment)
            return y2, c2, conv
        return jax.vmap(one)(ys, carries, cls, obss)

    convs = []
    step = step0
    while step < n_sim:
        ys, carries, conv = run_segment(state["ys"], state["carries"],
                                        scenarios.centerline,
                                        scenarios.obstacles)
        jax.block_until_ready(ys)
        state = {"ys": ys, "carries": carries}
        convs.append(np.asarray(conv))
        step += segment
        if checkpoint_path is not None:
            save_checkpoint(checkpoint_path, state, step=step)
    return state, np.concatenate(convs, axis=1) if convs else None


def _exists(path: str) -> bool:
    import os
    return os.path.exists(path)


def suite_summary(out: ClosedLoopOut, scenarios: ScenarioBatch):
    """Aggregate suite metrics (host-side)."""
    import numpy as np
    ys = np.asarray(out.ys)            # (B, n_sim, 6)
    conv = np.asarray(out.converged)   # (B, n_sim)
    iters = np.asarray(out.inner_iters)
    # distance of final position from final centerline point direction
    return {
        "scenarios": ys.shape[0],
        "steps": ys.shape[1],
        "total_solves": int(conv.size),
        "converged_fraction": float(conv.mean()),
        "mean_inner_iters": float(iters.mean()),
        "mean_final_speed": float(np.abs(ys[:, -1, 3]).mean()),
        "nan_scenarios": int(np.isnan(ys[:, -1]).any(axis=1).sum()),
    }

"""Game-theoretic lane-change decision layer — vectorized, batched.

JAX-native re-design of the reference's scalar/OO implementation
(reference: game_theory.py:21-244). Cars are structure-of-arrays with an
active mask (fixed MAX_CARS shape), every payoff is computed for all cars at
once, and whole scenario batches evaluate under one vmap — the reference's
Python loops over ``cars`` become masked reductions.

Semantics are transcribed *exactly*, including the reference's operator
precedence as written (e.g. ``self.v - car.v * self.tlc / 2 + self.L``
at game_theory.py:128 parses as ``v - (car.v*tlc/2) + L``; the same-lane
follow branch ``q1*self.v + self.td`` at game_theory.py:121-124 adds td
un-multiplied) — behavioral parity with the code, not with the formula one
might guess it intended.

Car state arrays: x (positions), v (speeds), lane (1 or 2), mask (active).
Ego is a separate (x, v, lane) triple. Default physical constants per the
reference Car.__init__ (game_theory.py:23-56).
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

# Reference Car defaults (game_theory.py:23-56).
CAR_L = 4.2
CAR_W = 1.8
SEG_L = 3.0
THETA_MAX = 3.2 / 180.0 * jnp.pi
TLC = 5.17
TD = 1.2
TI = 0.15
TAU = 0.9
A_MAX = 7.0
H_LANE = 3.75
LF = 1.0
Q1, Q2 = 0.65, 0.35
W_SAFETY, W_VELOCITY = 0.6, 0.4
BIG = 1e9


class Cars(NamedTuple):
    """Structure-of-arrays for up to MAX_CARS surrounding vehicles."""
    x: jnp.ndarray      # (M,)
    v: jnp.ndarray      # (M,)
    lane: jnp.ndarray   # (M,) int32, 1 or 2
    mask: jnp.ndarray   # (M,) bool

    @staticmethod
    def from_lists(xs, vs, lanes, max_cars=None) -> "Cars":
        n = len(xs)
        m = n if max_cars is None else max_cars
        pad = m - n
        return Cars(
            x=jnp.asarray(list(xs) + [0.0] * pad, jnp.float32),
            v=jnp.asarray(list(vs) + [0.0] * pad, jnp.float32),
            lane=jnp.asarray(list(lanes) + [0] * pad, jnp.int32),
            mask=jnp.asarray([True] * n + [False] * pad),
        )


class Ego(NamedTuple):
    x: jnp.ndarray
    v: jnp.ndarray
    lane: jnp.ndarray   # int32


def safety_distance(ego: Ego, cx, cv, clane, target_lane):
    """Piecewise safety distance S00/S01/S02/S03
    (reference: game_theory.py:115-153, transcribed branch-for-branch)."""
    v, x = ego.v, ego.x
    dv = v - cv

    # same lane branches
    s_follow = (Q1 * v + TD
                + Q2 * (dv * TAU + TI / 2 + dv ** 2 / (2 * A_MAX)) + SEG_L)
    s01_fast = v - cv * TLC / 2 + CAR_L + CAR_W / 2 * jnp.sin(THETA_MAX)
    s01_slow = Q1 * v * TD + SEG_L
    same_not_behind = jnp.where(
        target_lane == ego.lane, s_follow,
        jnp.where(v > cv, s01_fast, s01_slow))
    same = jnp.where(x > cx, jnp.abs(x - cx), same_not_behind)

    # different lane branches
    s02_fast = (v - cv * TLC / 2 + CAR_L - CAR_W / 2 * jnp.sin(THETA_MAX)
                + Q1 * v * TD
                + Q2 * (dv * TAU + TI / 2 + dv ** 2 / (2 * A_MAX)))
    s02 = jnp.where(v > cv, s02_fast, Q1 * v * TD + SEG_L)
    s03_slow = ((cv - v) * 3 / 4 * TLC + CAR_L + Q1 * cv * TD
                + Q2 * ((cv - v) * TAU + TI / 2 + (cv - v) ** 2 / (2 * A_MAX)))
    s03 = jnp.where(v < cv, s03_slow, Q1 * cv * TD + SEG_L)
    diff = jnp.where(x < cx, s02, s03)

    return jnp.where(ego.lane == clane, same, diff)


def safety_payoff(ego: Ego, cars: Cars, target_lane):
    """Min-over-cars banded payoff (reference: game_theory.py:155-177):
    1 outside the safety distance, -1 within car length l, log-interpolated
    between."""
    sk = safety_distance(ego, cars.x, cars.v, cars.lane, target_lane)
    dk = jnp.abs(ego.x - cars.x)
    t = jnp.where(dk >= jnp.abs(sk), 1.0, jnp.nan)
    t = jnp.where(dk <= SEG_L, -1.0, t)
    mid = (SEG_L < dk) & (dk < jnp.abs(sk))
    t = jnp.where(mid, jnp.log(dk / sk + 1.0) / jnp.log(2.0), t)
    t = jnp.nan_to_num(t, nan=1.0)
    # skip cars in another lane when staying in lane (game_theory.py:158-160)
    skip = (ego.lane != cars.lane) & (ego.lane == target_lane)
    consider = cars.mask & ~skip
    return jnp.min(jnp.where(consider, t, 1.0))


def _car_in_front(ego: Ego, cars: Cars, target_lane):
    """Nearest active car ahead in target lane; (exists, v_front)."""
    ahead = cars.mask & (cars.lane == target_lane) & (cars.x > ego.x)
    xf = jnp.where(ahead, cars.x, BIG)
    i = jnp.argmin(xf)
    return ahead.any(), cars.v[i]


def _car_behind(ego: Ego, cars: Cars):
    """Nearest active lane-2 car behind ego (reference: game_theory.py:77-90
    hardcodes lane 2); (exists, index)."""
    behind = cars.mask & (cars.lane == 2) & (cars.x < ego.x)
    xb = jnp.where(behind, cars.x, -BIG)
    i = jnp.argmax(xb)
    return behind.any(), i


def velocity_payoff(ego: Ego, cars: Cars, target_lane):
    """(v_front - v)/v banded to [-1, 1] (reference: game_theory.py:179-190)."""
    exists, vf = _car_in_front(ego, cars, target_lane)
    p = jnp.where(vf == 0.0, -1.0,
                  jnp.where(vf >= 2 * ego.v, 1.0, (vf - ego.v) / ego.v))
    return jnp.where(exists, p, 1.0)


def comfort_payoff(ego: Ego, cars: Cars, target_lane):
    """Sigmoid of the Bezier time-to-collision-avoidance
    (reference: game_theory.py:192-203). Computed for API parity but —
    exactly like the reference (game_theory.py:205-211) — NOT included in
    the total payoff."""
    exists, vf = _car_in_front(ego, cars, 1)
    # Bezier tca with D1 = gap to the car in front (game_theory.py:92-113)
    ahead = cars.mask & (cars.lane == 1) & (cars.x > ego.x)
    xf = jnp.where(ahead, cars.x, BIG)
    d1 = xf[jnp.argmin(xf)] - ego.x
    li = LF + SEG_L
    di = li * jnp.cos(jnp.arctan2(CAR_W, 2 * LF) - THETA_MAX)
    tc1 = d1 / (ego.v - vf)
    px2 = ego.v * tc1 - di
    tca = px2 / (ego.v - vf)
    p = 2.0 / (1.0 + jnp.exp(-tca)) - 2.0
    applies = (target_lane == 2) & exists & (ego.v > vf)
    return jnp.where(applies, p, 0.0)


def total_payoff(ego: Ego, cars: Cars, target_lane, a=W_SAFETY, b=W_VELOCITY):
    """a*safety + b*velocity plus the rear lane-2 car's payoff with a ghost
    ego inserted when changing lane (the altruistic/Stackelberg term,
    reference: game_theory.py:205-244)."""
    total = (a * safety_payoff(ego, cars, target_lane)
             + b * velocity_payoff(ego, cars, target_lane))

    exists, bi = _car_behind(ego, cars)

    # the rear car's world: all other cars except itself...
    mask_wo_behind = cars.mask & (jnp.arange(cars.x.shape[0]) != bi)
    # ...plus a ghost copy of ego in lane 2 when ego changes lane
    ghost = target_lane == 2
    ext = Cars(
        x=jnp.concatenate([cars.x, ego.x[None]]),
        v=jnp.concatenate([cars.v, ego.v[None]]),
        lane=jnp.concatenate([cars.lane, jnp.asarray([2], jnp.int32)]),
        mask=jnp.concatenate([mask_wo_behind, ghost[None]]),
    )
    rear = Ego(x=cars.x[bi], v=cars.v[bi], lane=cars.lane[bi])
    total_behind = (a * safety_payoff(rear, ext, 2)
                    + b * velocity_payoff(rear, ext, 2))
    return total + jnp.where(exists, total_behind, 0.0)


def lane_payoffs(ego: Ego, cars: Cars):
    """Payoff for staying (lane 1) vs changing (lane 2)."""
    return jnp.stack([
        total_payoff(ego, cars, jnp.asarray(1, jnp.int32)),
        total_payoff(ego, cars, jnp.asarray(2, jnp.int32)),
    ])


# batched over scenarios: ego fields (B,), cars fields (B, M)
lane_payoffs_batched = jax.vmap(lane_payoffs)


def decision_rollout(ego: Ego, cars: Cars, n_steps: int = 50, dt: float = 0.1):
    """Constant-velocity decision scan (reference: game_theory.py:352-383):
    per step compute lane payoffs, move every car, flag the change decision
    payoff(2) > payoff(1)."""
    def step(carry, _):
        ego, cars = carry
        p = lane_payoffs(ego, cars)
        ego2 = ego._replace(x=ego.x + ego.v * dt)
        cars2 = cars._replace(x=cars.x + cars.v * dt)
        return (ego2, cars2), (p, p[1] > p[0])

    (_, _), (payoffs, change) = jax.lax.scan(step, (ego, cars), None,
                                             length=n_steps)
    return payoffs, change


def iterated_best_response(egos: Ego, cars_list: Cars, n_rounds: int = 3):
    """Iterated best response over a batch of interacting agents.

    Each round, every agent re-evaluates its lane decision against the
    others' current lanes; a fixed point of this map is a pure-strategy Nash
    equilibrium of the one-shot lane game. The reference only ever evaluates
    one round for a single ego (game_theory.py:363-367); this generalizes it
    to config #4's alternating batched solves. ``egos`` fields are (A,)
    arrays of A agents; ``cars_list`` is the (A, M) per-agent view of the
    other agents.
    """
    def round_fn(lanes, _):
        def one(i):
            ego = Ego(x=egos.x[i], v=egos.v[i], lane=lanes[i])
            others = Cars(x=cars_list.x[i], v=cars_list.v[i],
                          lane=cars_list.lane[i], mask=cars_list.mask[i])
            p = lane_payoffs(ego, others)
            return jnp.where(p[1] > p[0], 2, 1).astype(jnp.int32)

        new_lanes = jax.vmap(one)(jnp.arange(egos.x.shape[0]))
        return new_lanes, new_lanes

    lanes0 = egos.lane
    lanes, hist = jax.lax.scan(round_fn, lanes0, None, length=n_rounds)
    return lanes, hist


# ---------------------------------------------------------------------------
# Reference scenario fixtures (game_theory.py:247-349)
# ---------------------------------------------------------------------------

def scenario_1():
    ego = Ego(x=jnp.asarray(0.0), v=jnp.asarray(10.0),
              lane=jnp.asarray(1, jnp.int32))
    cars = Cars.from_lists([50.0, 10.0, -20.0, -30.0],
                           [0.0, 15.0, 15.0, 15.0], [1, 2, 2, 2])
    return ego, cars


def scenario_2():
    ego = Ego(x=jnp.asarray(0.0), v=jnp.asarray(10.0),
              lane=jnp.asarray(1, jnp.int32))
    cars = Cars.from_lists([50.0, 10.0, -8.0, -25.0],
                           [0.0, 15.0, 15.0, 15.0], [1, 2, 2, 2])
    return ego, cars


def scenario_3():
    ego = Ego(x=jnp.asarray(0.0), v=jnp.asarray(10.0),
              lane=jnp.asarray(1, jnp.int32))
    cars = Cars.from_lists([50.0, 10.0, -8.0, -18.0],
                           [0.0, 15.0, 15.0, 15.0], [1, 2, 2, 2])
    return ego, cars

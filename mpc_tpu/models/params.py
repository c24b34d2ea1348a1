"""Vehicle parameter pytree.

JAX-native equivalent of the reference's ``VehicleParameters`` plain class
(reference: dynamics.py:4-42) and the flat 22-element parameter vector used by
the symbolic model (reference: car_dynamics.py:65-88, main.py:88-111).

Design notes:
- A single frozen dataclass registered as a JAX pytree. Every field is a leaf,
  so a ``VehicleParams`` can carry scalars *or* batched arrays — the same
  dynamics function serves one car or a sharded batch of 100k cars via vmap.
- ``to_vector``/``from_vector`` preserve the reference's canonical flat
  ordering (main.py:88-111): length, axis_front, axis_rear, front, rear,
  width, height, mass, inertia, max_steer, max_drive, bf, cf, df, br, cr, dr,
  cm1, cm2, cr0, cr1, cr2.  (``cr1`` is declared but unused by the dynamics in
  the reference too — kept for vector-layout parity.)
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

# Canonical flat ordering of the 22 physical parameters
# (reference: main.py:88-111, car_dynamics.py:65-88).
PARAM_FIELDS = (
    "length", "axis_front", "axis_rear", "front", "rear", "width", "height",
    "mass", "inertia", "max_steer", "max_drive",
    "bf", "cf", "df", "br", "cr", "dr",
    "cm1", "cm2", "cr0", "cr1", "cr2",
)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VehicleParams:
    """Physical constants of the 1:43-scale RC car (reference: dynamics.py:4-42)."""

    # geometry (meters)
    length: Any = 9.7e-2          # car length
    axis_front: Any = 4.7e-2      # cog -> front axle
    axis_rear: Any = 5e-2         # cog -> rear axle
    front: Any = 0.09             # cog -> front bumper
    rear: Any = 0.07              # cog -> rear bumper
    width: Any = 8e-2
    height: Any = 5.5e-2
    mass: Any = 0.1735            # kg
    inertia: Any = 18.3e-5        # yaw moment of inertia (kg m^2)

    # input limits
    max_steer: Any = 0.32         # rad
    max_drive: Any = 1.0

    # Pacejka magic-formula coefficients: peak * sin(shape * atan(stiffness * alpha))
    bf: Any = 0.268               # front stiffness
    cf: Any = 2.165               # front shape
    df: Any = 3.47                # front peak
    br: Any = 0.242               # rear stiffness
    cr: Any = 2.38                # rear shape
    dr: Any = 2.84                # rear peak

    # kinematic approximation (simplified bicycle, reference: dynamics.py:34-35)
    friction: Any = 1.0
    acceleration: Any = 2.0

    # motor / rolling-resistance model
    cm1: Any = 0.266
    cm2: Any = 0.1
    cr0: Any = 0.1025
    cr1: Any = 0.1629             # declared but unused by the ODE (parity with reference)
    cr2: Any = 0.0011

    def to_vector(self) -> jnp.ndarray:
        """Flatten to the reference's canonical 22-vector (main.py:88-111)."""
        return jnp.stack(
            [jnp.asarray(getattr(self, f), dtype=jnp.float32) for f in PARAM_FIELDS]
        )

    @classmethod
    def from_vector(cls, vec) -> "VehicleParams":
        """Rebuild from the canonical 22-vector; keeps default friction/acceleration."""
        kwargs = {f: vec[i] for i, f in enumerate(PARAM_FIELDS)}
        return cls(**kwargs)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChainParams:
    """Hanging-chain physical parameters (reference: alpaqa_example.py:34-38,154)."""

    m: Any = 0.03          # ball mass
    D: Any = 1.6           # spring constant
    L: Any = 0.033 / 6     # spring rest length (reference uses 0.033 / N with N=6)

    def to_vector(self) -> jnp.ndarray:
        return jnp.stack([jnp.asarray(v, dtype=jnp.float32) for v in (self.m, self.D, self.L)])

    @classmethod
    def from_vector(cls, vec) -> "ChainParams":
        return cls(m=vec[0], D=vec[1], L=vec[2])

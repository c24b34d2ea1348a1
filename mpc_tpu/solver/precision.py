"""The float32 matmul precision every solver is traced under.

On GPUs XLA may run a float32 ``dot_general`` at DEFAULT precision in TF32,
which keeps about three decimal digits. The solvers are float32 throughout
and rely on it: the PANOC quadratic-upper-bound margin and stagnation exits
(solver/panoc.py), the L-BFGS curvature pairs, and the Riccati gains
(solver/lqr.py) all assume full f32 products. Every solver factory returns
its callable wrapped in :func:`pinned_precision`, so each contraction the
solve traces carries ``precision=HIGHEST`` whatever the caller's global
setting. The package changes no global config at import.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax

MATMUL_PRECISION = "highest"


def pinned_precision(fn: Callable) -> Callable:
    """Trace ``fn`` under ``jax.default_matmul_precision(MATMUL_PRECISION)``.

    Precision is fixed when a ``dot_general`` is traced, so the wrapper also
    holds when ``fn`` is called inside an outer ``jit``, ``vmap`` or
    ``shard_map``.
    """
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(MATMUL_PRECISION):
            return fn(*args, **kwargs)

    return wrapped

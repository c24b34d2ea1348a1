"""Checkpoint/resume for long scenario suites.

The reference carries no persistent state beyond the in-memory warm start
(controller.py:20-21); for the 10k-rollout suites (BASELINE.json config #5)
we checkpoint the full closed-loop state — plant states, warm-start inputs,
multipliers, step index, RNG key — so a long run can resume after
preemption. Pytrees are saved as flat .npz archives (orbax-free: no extra
dependency, atomic single-file writes).

Leaves are keyed by their jax tree *path* (e.g. ``['carries'].sigma``), not
by position, and shapes/dtypes are validated on load: a checkpoint written
before a pytree gained or lost fields fails with a clear "incompatible
checkpoint" error instead of a KeyError or a silent positional mis-assign.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Tuple

import jax
import numpy as np

_STEP_KEY = "__step__"
_PATH_PREFIX = "path:"


def _flatten_with_paths(tree: Any):
    """Flatten to [(path_string, leaf)] using jax key paths."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(path), leaf) for path, leaf in flat]


def save_checkpoint(path: str, tree: Any, step: int = 0) -> str:
    """Atomically save a pytree of arrays to ``path`` (.npz)."""
    arrays = {_PATH_PREFIX + k: np.asarray(v)
              for k, v in _flatten_with_paths(tree)}
    arrays[_STEP_KEY] = np.asarray(step)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_checkpoint(path: str, example_tree: Any) -> Tuple[Any, int]:
    """Load a pytree saved by :func:`save_checkpoint`.

    ``example_tree`` provides the structure (and the expected shapes/dtypes).
    Raises ``ValueError`` naming the offending leaves when the checkpoint
    does not match — missing/extra paths or shape/dtype mismatches.
    """
    expected = _flatten_with_paths(example_tree)
    with np.load(path) as data:
        saved = {k[len(_PATH_PREFIX):]: data[k] for k in data.files
                 if k.startswith(_PATH_PREFIX)}
        if _STEP_KEY not in data.files:
            raise ValueError(
                f"incompatible checkpoint {path!r}: no step record "
                "(not written by save_checkpoint?)")
        step = int(data[_STEP_KEY])

    missing = [k for k, _ in expected if k not in saved]
    extra = sorted(set(saved) - {k for k, _ in expected})
    if missing or extra:
        raise ValueError(
            f"incompatible checkpoint {path!r}: "
            f"missing leaves {missing}, unexpected leaves {extra} "
            "(pytree structure changed since the checkpoint was written)")

    leaves = []
    bad = []
    for k, ex in expected:
        arr = saved[k]
        ex_arr = np.asarray(ex)
        if arr.shape != ex_arr.shape or arr.dtype != ex_arr.dtype:
            bad.append(f"{k}: saved {arr.dtype}{list(arr.shape)} vs expected "
                       f"{ex_arr.dtype}{list(ex_arr.shape)}")
        leaves.append(arr)
    if bad:
        raise ValueError(
            f"incompatible checkpoint {path!r}: shape/dtype mismatch — "
            + "; ".join(bad))

    treedef = jax.tree_util.tree_structure(example_tree)
    return jax.tree_util.tree_unflatten(treedef, leaves), step

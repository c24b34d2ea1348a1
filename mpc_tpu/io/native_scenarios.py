"""ctypes loader for the native C++ scenario generator.

Compiles ``native/scenario_gen.cpp`` on first use (cached as a shared
library next to the source; rebuilt when the source or ABI changes) and
exposes :func:`generate_scenarios` filling numpy buffers from a C++ thread
pool — the host-side data path that overlaps scenario generation with device
execution. Falls back transparently to the pure-JAX generator
(mpc_tpu.sim.scenarios.random_scenarios) when no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "scenario_gen.cpp")

_lock = threading.Lock()
_lib = None
_lib_error: Optional[str] = None


def _source_tag() -> str:
    with open(_SRC, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def _build() -> str:
    tag = _source_tag()
    out = os.path.join(os.path.dirname(_SRC), f"libscenario_gen_{tag}.so")
    if os.path.exists(out):
        return out
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
           "-pthread", _SRC, "-o", out + ".tmp"]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(out + ".tmp", out)
    return out


def _load():
    global _lib, _lib_error
    with _lock:
        if _lib is not None or _lib_error is not None:
            return _lib
        try:
            path = _build()
            lib = ctypes.CDLL(path)
            lib.mpc_generate_scenarios.argtypes = [
                ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ]
            lib.mpc_generate_scenarios.restype = None
            lib.mpc_scenario_gen_abi_version.restype = ctypes.c_int
            assert lib.mpc_scenario_gen_abi_version() == 1
            _lib = lib
        except Exception as e:  # toolchain missing / build failure
            _lib_error = f"{type(e).__name__}: {e}"
        return _lib


def native_available() -> bool:
    return _load() is not None


def generate_scenarios(seed: int, batch: int, size: int = 100,
                       n_obstacles: int = 2, n_threads: int = 0):
    """Generate a scenario batch with the native generator.

    Returns a ``mpc_tpu.sim.scenarios.ScenarioBatch`` of numpy-backed
    arrays (host memory; feed to jax.device_put / the batched closed loop).
    Falls back to the JAX generator when the native library is unavailable.
    """
    from mpc_tpu.sim.scenarios import ScenarioBatch

    lib = _load()
    if lib is None:
        import jax
        from mpc_tpu.sim.scenarios import random_scenarios
        return random_scenarios(jax.random.PRNGKey(seed), batch, size,
                                n_obstacles)

    cl = np.empty((batch, size, 2), np.float32)
    y0 = np.empty((batch, 6), np.float32)
    obs = np.empty((batch, n_obstacles, 4), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.mpc_generate_scenarios(
        ctypes.c_uint64(seed), batch, size, n_obstacles,
        cl.ctypes.data_as(fp), y0.ctypes.data_as(fp), obs.ctypes.data_as(fp),
        n_threads)
    return ScenarioBatch(y0=y0, centerline=cl, obstacles=obs)


class ScenarioPrefetcher:
    """Double-buffered background generation: the next batch is produced on a
    host thread while the device consumes the current one."""

    def __init__(self, seed: int, batch: int, size: int = 100,
                 n_obstacles: int = 2):
        self._seed = seed
        self._batch = batch
        self._size = size
        self._n_obs = n_obstacles
        self._idx = 0
        self._pending = None
        self._kick()

    def _gen(self, idx):
        return generate_scenarios(self._seed + idx, self._batch, self._size,
                                  self._n_obs)

    def _kick(self):
        idx = self._idx
        result = {}

        def run():
            result["batch"] = self._gen(idx)

        t = threading.Thread(target=run, daemon=True)
        t.start()
        self._pending = (t, result)

    def next(self):
        t, result = self._pending
        t.join()
        out = result["batch"]
        self._idx += 1
        self._kick()
        return out

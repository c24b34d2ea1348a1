"""Measurement records and the device stamp every recorded number carries.

:func:`record` appends a result to ``.perf_results.json`` at the repo root
(a run-time artifact, listed in ``.gitignore``), keyed by experiment id and
stamped with :func:`device_stamp` and the date. ``PERF.md`` is written by
hand from such records; nothing here regenerates it. The reference *prints*
its counters every solve (reference: controller.py:59-64) and records
nothing.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS_PATH = os.path.join(REPO, ".perf_results.json")

NVIDIA_SMI_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]


def gpu_name_and_power_limit() -> list:
    """One ``"<name>, <power limit>"`` line per card, as nvidia-smi prints
    them. Raises when nvidia-smi is missing or fails."""
    out = subprocess.run(NVIDIA_SMI_QUERY, capture_output=True, text=True,
                         timeout=60, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi listed no GPU")
    return lines


def device_stamp() -> dict:
    """The device a measurement ran on: JAX's platform, device kind and
    count, plus each card's name and power limit (``None`` off a GPU)."""
    import jax

    devs = jax.devices()
    stamp = {"platform": devs[0].platform, "kind": devs[0].device_kind,
             "count": len(devs), "nvidia_smi": None}
    if devs[0].platform == "gpu":
        stamp["nvidia_smi"] = gpu_name_and_power_limit()
    return stamp


def load() -> dict:
    if os.path.exists(RESULTS_PATH):
        with open(RESULTS_PATH) as f:
            return json.load(f)
    return {}


def record(key: str, result: dict) -> dict:
    """Store ``result`` under ``key``, stamped with the device and date."""
    results = load()
    result = dict(result)
    result.setdefault("device", device_stamp())
    result.setdefault("recorded", time.strftime("%Y-%m-%d"))
    results[key] = result
    with open(RESULTS_PATH, "w") as f:
        json.dump(results, f, indent=1)
    return results

"""chip_smoke.py's contract, checked on the CPU, and the compile-cache path.

What only the GPU can run lives in chip_smoke.py itself; these tests hold
the parts that decide pass or fail: the device check, the exact last line,
the phase selection of ``--multi``, and the mesh phases at tiny sizes on
virtual CPU devices (the rehearsal of the four-GPU run).
"""

import json
import os
import types

import jax
import pytest

import chip_smoke
from mpc_tpu.utils import compile_cache


def _fake_gpus(n):
    return [types.SimpleNamespace(platform="gpu",
                                  device_kind="NVIDIA H100 80GB HBM3")] * n


def test_device_phase_refuses_cpu():
    with pytest.raises(chip_smoke.PhaseFailed, match="no GPU"):
        chip_smoke.phase_device(jax.devices())


def test_device_phase_needs_four_gpus_for_multi(monkeypatch):
    monkeypatch.setattr(chip_smoke, "gpu_name_and_power_limit",
                        lambda: ["NVIDIA H100 80GB HBM3, 700.00 W"])
    with pytest.raises(chip_smoke.PhaseFailed, match="needs 4"):
        chip_smoke.phase_device(_fake_gpus(1), min_count=4)
    out = chip_smoke.phase_device(_fake_gpus(4), min_count=4)
    assert out["count"] == 4
    assert out["nvidia_smi"] == ["NVIDIA H100 80GB HBM3, 700.00 W"]


@pytest.mark.parametrize("argv", [[], ["--multi"]])
def test_main_on_cpu_fails_without_ok_line(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok": true' not in out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["phase"] == "device" and last["ok"] is False


@pytest.mark.parametrize("n", [1, 4])
def test_final_line_schema(n):
    line = chip_smoke.final_line(_fake_gpus(n))
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": %d}}' % n)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": n}}


def test_multi_selects_only_mesh_phases():
    assert [n for n, _ in chip_smoke.phases(multi=False)] == [
        "device", "headline", "closed_loop", "oracle", "al_ilqr"]
    assert [n for n, _ in chip_smoke.phases(multi=True)] == [
        "device", "precompile", "scenario_mesh", "road_mesh",
        "horizon_mesh", "dryrun"]


@pytest.mark.parametrize("phase", ["scenario_mesh", "road_mesh",
                                   "horizon_mesh"])
def test_mesh_phases_on_four_virtual_devices(phase):
    devices = jax.devices()[:4]
    if phase == "horizon_mesh":
        out = chip_smoke.phase_horizon_mesh(devices, batch=4, n_horiz=6)
    else:
        out = getattr(chip_smoke, f"phase_{phase}")(devices, batch=8,
                                                     n_horiz=4)
    assert out["max_abs_u0_diff" if phase == "horizon_mesh"
               else "max_abs_u_diff"] <= out["atol"]


def test_precompile_compiles_what_the_mesh_phases_run(monkeypatch):
    devices = jax.devices()[:4]
    for name, value in [("SCENARIO_BATCH", 8), ("ROAD_BATCH", 4),
                        ("MESH_N_HORIZ", 4), ("HORIZON_BATCH", 4),
                        ("HORIZON_N", 6)]:
        monkeypatch.setattr(chip_smoke, name, value)
    out = chip_smoke.phase_precompile(devices)
    assert set(out["compile_s"]) == {"scenario_mesh", "road_mesh",
                                     "horizon_mesh", "one_card_solve",
                                     "one_card_horizon"}
    # the phases find the same jitted objects, lists or tuples of devices
    assert (chip_smoke.sharded_solver(devices, 4, 1, 4)
            is chip_smoke.sharded_solver(tuple(devices), 4, 1, 4))
    assert (chip_smoke.horizon_step(devices[:1], 1, 1, 4, 6)[0]
            is chip_smoke.horizon_step(tuple(devices[:1]), 1, 1, 4, 6)[0])
    out = chip_smoke.phase_road_mesh(devices, batch=4, n_horiz=4)
    assert out["max_abs_u_diff"] <= out["atol"]


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX read the variable itself; nothing is set in code
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert compile_cache.compile_cache_dir() == path
    assert str(os.getpid()) not in path
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()

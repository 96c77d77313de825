"""chip_smoke.py's phases at tiny sizes on the CPU.

The script itself refuses to run without a GPU; these drive its phase
functions directly on the virtual CPU devices, and its entry point with
the platform check stubbed out.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import chip_smoke  # noqa: E402


def test_target_highest_matches_float64():
    out = chip_smoke.phase_target(jax.devices(), n=1 << 12)
    assert out["failed"] == []
    assert out["max_rel_err_highest"] <= 1e-5
    assert np.isfinite(out["max_rel_err_default"])


def test_main_moments_at_w1024():
    # W=2^10 over 40 rows: >= 1024 effective draws, so a covariance entry's
    # standard error is <= sqrt(1.25/1024) = 0.035; 0.15 is > 4 of them
    out = chip_smoke.phase_main(
        jax.devices(), n_walkers=1 << 10, n_rows=40, launch_steps=20,
        timed_launches=1, tol=0.15,
    )
    assert out["failed"] == []
    assert 0.2 <= out["acceptance"] <= 0.8
    assert out["chain_backend"] in ("native", "numpy")
    assert out["us_per_step"] > 0


def test_cross_backend_cpu_vs_cpu():
    devs = jax.devices()
    out = chip_smoke.phase_cross_backend(devs, n_walkers=1 << 10,
                                         other=devs[1])
    assert out["failed"] == []
    assert out["accept_differ_share"] == 0.0
    assert out["walkers_beyond_tol"] == 0


def test_ess_phase_tiny_window():
    out = chip_smoke.phase_ess(jax.devices(), w_log2=8, steps=2400, thin=8)
    assert out["failed"] == []
    taus = np.asarray(out["taus"])
    assert taus.shape == (chip_smoke.DIM,)
    assert np.all(taus > 0) and np.all(np.isfinite(taus))
    assert out["ess_per_s"] > 0


def test_multi_gpu_phase_on_four_cpu_devices():
    out = chip_smoke.phase_multi_gpu(jax.devices()[:4], n_walkers=1 << 10)
    assert out["failed"] == []
    assert out["bitwise"] is True
    assert out["mesh"] == {"hosts": 1, "devices": 4}


def test_multi_gpu_phase_needs_four_devices():
    with pytest.raises(RuntimeError, match="4 devices"):
        chip_smoke.phase_multi_gpu(jax.devices()[:2], n_walkers=1 << 6)


def test_main_without_gpu_exits_nonzero(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_final_line_exact_keys():
    line = json.loads(chip_smoke.final_line(jax.devices()))
    assert list(line) == ["ok", "device"]
    assert line["ok"] is True
    assert list(line["device"]) == ["platform", "kind", "count"]
    assert line["device"]["platform"] == jax.devices()[0].platform
    assert line["device"]["count"] == len(jax.devices())


@pytest.mark.parametrize("argv, expected", [
    ([], chip_smoke.SINGLE_GPU_PHASES),
    (["--multi-gpu"], chip_smoke.MULTI_GPU_PHASES),
])
def test_main_runs_only_planned_phases(monkeypatch, capsys, argv, expected):
    ran = []
    for name in ("target", "main", "cross_backend", "ess", "multi_gpu"):
        monkeypatch.setattr(
            chip_smoke, "phase_" + name,
            lambda devs, name=name: ran.append(name) or {"failed": []},
        )
    monkeypatch.setattr(chip_smoke, "require_gpu", jax.devices)
    monkeypatch.setattr(chip_smoke, "card_info", lambda: "Card X, 1.00 W")
    monkeypatch.setattr(bench, "use_compile_cache", lambda root: None)
    assert chip_smoke.main(argv) == 0
    assert tuple(ran) == expected
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1])["ok"] is True
    assert "Card X, 1.00 W" in lines[:-1]
    phases = [json.loads(ln)["phase"] for ln in lines if ln.startswith("{")
              and "phase" in json.loads(ln)]
    assert phases == ["device", *expected]


def test_failed_phase_prints_no_ok_line(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "phase_target",
                        lambda devs: {"failed": ["broken"]})
    monkeypatch.setattr(chip_smoke, "require_gpu", jax.devices)
    monkeypatch.setattr(chip_smoke, "card_info", lambda: "Card X, 1.00 W")
    monkeypatch.setattr(bench, "use_compile_cache", lambda root: None)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_compile_cache_env_set_is_untouched(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert bench.use_compile_cache(str(tmp_path)) == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_unset_uses_repo_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = bench.use_compile_cache(str(tmp_path))
        assert path == str(tmp_path / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert bench.REPO == str(ROOT)


def test_main_path_imports_no_optional_packages():
    """chip_smoke (and the library under it) must not pull in h5py or
    sklearn, and import sets no compile cache."""
    code = (
        "import sys, jax, chip_smoke; "
        "bad = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'h5py', 'sklearn', 'torch', 'triton'}); "
        "assert not bad, bad; "
        "assert jax.config.jax_compilation_cache_dir is None"
    )
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=300)

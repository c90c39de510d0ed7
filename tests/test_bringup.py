"""The GPU bring-up contract, checked on the CPU: chip_smoke.py's refusal
without a GPU and its final-line contract, and the compile-cache location.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

import jax

from rtw.utils import compile_cache as CC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")


def _run_smoke(path, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, path], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu(tmp_path):
    out = _run_smoke(SMOKE, str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not 'gpu'" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot run."""
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SMOKE, lone)
    out = _run_smoke(str(lone), str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_last_line_contract(monkeypatch, capsys, tmp_path):
    sys.path.insert(0, ROOT)
    import chip_smoke as C

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(C, "_nvidia_smi",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(CC, "enable_compile_cache", lambda: "unused")
    ran = []
    for name in ("phase_parity", "phase_kernel", "phase_renders"):
        monkeypatch.setattr(C, name, lambda name=name: ran.append(name))
    monkeypatch.setattr(C, "OUT", str(tmp_path))
    assert C.main([]) == 0
    assert ran == ["phase_parity", "phase_kernel", "phase_renders"]
    lines = capsys.readouterr().out.strip().splitlines()
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in lines[0]
    last = json.loads(lines[-1])
    assert set(last) == {"ok", "device"} and last["ok"] is True
    assert set(last["device"]) == {"platform", "kind", "count"}
    assert last["device"]["count"] == len(jax.devices())

    # a failing phase: nonzero exit and no ok line
    def boom():
        raise AssertionError("phase failed")

    monkeypatch.setattr(C, "phase_kernel", boom)
    assert C.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env_set:
        monkeypatch.setenv(CC.ENV, str(tmp_path))
        assert CC.enable_compile_cache() == str(tmp_path)
        assert calls == []          # JAX reads the variable itself
    else:
        monkeypatch.delenv(CC.ENV, raising=False)
        path = CC.enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
        with open(os.path.join(ROOT, ".gitignore")) as f:
            assert ".jax_cache/" in f.read().split()


def test_former_package_name_resolves_to_rtw():
    """The repo's one top-level package besides rtw and tools is the
    package's former import name: its modules are the rtw modules
    themselves (one object, one jit cache), and `python -m` reaches the
    CLI through it."""
    import importlib

    import rtw
    import rtw.cli
    import rtw.parallel.mesh

    names = sorted(d for d in os.listdir(ROOT)
                   if os.path.isfile(os.path.join(ROOT, d, "__init__.py"))
                   and d not in ("rtw", "tools"))
    assert len(names) == 1, names
    old = names[0]
    assert importlib.import_module(old) is rtw
    assert importlib.import_module(old + ".cli") is rtw.cli
    assert (importlib.import_module(old + ".parallel.mesh").render_sharded
            is rtw.parallel.mesh.render_sharded)
    assert rtw.cli.__spec__.name == "rtw.cli"
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-m", old + ".cli", "--help"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert "--denoise" in out.stdout

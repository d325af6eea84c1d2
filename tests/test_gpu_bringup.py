"""How the program finds and refuses devices: the compile-cache location,
the multi-process runtime's backend choice, and ``chip_smoke.py``'s device
check and phase selection.  All of it runs here on the CPU."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import fxtpu
from fxtpu.parallel import multihost

REPO = Path(__file__).resolve().parent.parent


def _env(**overrides):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env["PYTHONPATH"] = str(REPO)
    env.update(overrides)
    return env


# ------------------------------------------------------------ compile cache
@pytest.mark.parametrize("var", [None, "set"])
def test_compile_cache_dir(tmp_path, var):
    """Unset: one fixed directory inside the checkout, git-ignored.  Set:
    JAX's own reading of the variable, untouched by the package."""
    env = _env(JAX_PLATFORMS="cpu")
    if var:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
    r = subprocess.run(
        [sys.executable, "-c",
         "import fxtpu, jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    got = r.stdout.strip().splitlines()[-1]
    if var:
        assert got == str(tmp_path / "cc")
    else:
        assert got == str(REPO / ".jax_cache") == str(fxtpu.CACHE_DIR)
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


# ------------------------------------------------------- multi-process init
@pytest.fixture
def recorder(monkeypatch):
    """Record jax.config.update and jax.distributed.initialize calls
    instead of making them (the test process's backend is already up)."""
    import jax
    calls = {"config": [], "init": []}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls["config"].append((k, v)))
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls["init"].append(kw))
    monkeypatch.setenv("XLA_FLAGS", "")
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    return calls


def test_init_runtime_uses_gpu_unless_asked(recorder):
    multihost.init_runtime(1, 2, "localhost:1234")
    assert ("jax_platforms", "cpu") not in recorder["config"]
    assert not [c for c in recorder["config"]
                if c[0] == "jax_cpu_collectives_implementation"]
    assert os.environ["XLA_FLAGS"] == ""
    assert recorder["init"] == [dict(coordinator_address="localhost:1234",
                                     num_processes=2, process_id=1,
                                     local_device_ids=[1])]


def test_init_runtime_cpu_when_asked(recorder):
    multihost.init_runtime(0, 2, "localhost:1234", local_devices=3,
                           platform="cpu")
    assert ("jax_platforms", "cpu") in recorder["config"]
    assert ("jax_cpu_collectives_implementation", "gloo") in \
        recorder["config"]
    assert "--xla_force_host_platform_device_count=3" in \
        os.environ["XLA_FLAGS"]
    assert "local_device_ids" not in recorder["init"][0]


def test_init_runtime_cpu_from_env(recorder, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert multihost.wants_cpu() and not multihost.wants_cpu("gpu")
    multihost.init_runtime(0, 2, "localhost:1234")
    assert ("jax_platforms", "cpu") in recorder["config"]


def test_init_runtime_pinned_card(recorder, monkeypatch):
    """A launcher that pinned one card leaves device choice to it."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3")
    multihost.init_runtime(1, 2, "localhost:1234", platform="gpu")
    assert ("jax_platforms", "gpu") in recorder["config"]
    assert "local_device_ids" not in recorder["init"][0]


@pytest.mark.parametrize("platform,visible,want", [
    ("gpu", None, ["0", "1"]),
    ("gpu", "4,5", ["4", "5"]),
    ("cpu", None, [None, None]),
])
def test_launch_pins_one_card_per_worker(monkeypatch, platform, visible,
                                         want):
    seen = []

    class FakeProc:
        returncode = 0
        args = ()

        def __init__(self, cmd, env, **kw):
            seen.append((cmd, env))

        def communicate(self, timeout=None):
            return "ok", None

    monkeypatch.setattr(multihost.subprocess, "Popen", FakeProc)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    if visible:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    else:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    multihost.launch(2, "step", [], coordinator="localhost:1",
                     platform=platform)
    assert [env.get("CUDA_VISIBLE_DEVICES") for _, env in seen] == want
    for cmd, _ in seen:
        assert cmd[cmd.index("--platform") + 1] == platform


# --------------------------------------------------------------- chip_smoke
def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_refuses_cpu(tmp_path):
    """No GPU: non-zero exit, and no result line."""
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                       env=_env(JAX_PLATFORMS="cpu"), cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script cannot run."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env(JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH")
    r = subprocess.run([sys.executable, "chip_smoke.py"], env=env,
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("four_cards", [False, True])
def test_chip_smoke_phase_selection(monkeypatch, capsys, four_cards):
    """--four-cards runs the four-card phase and no other; without it every
    single-card phase runs.  The last line is the result object."""
    cs = _load_chip_smoke()
    import fxtpu.runtime.device as device
    ran = []
    monkeypatch.setattr(device, "require_gpu", lambda: None)
    monkeypatch.setattr(device, "card_line", lambda: "test card, 1 W")
    monkeypatch.setattr(device, "device_info", lambda: {
        "platform": "gpu", "kind": "test", "count": 4 if four_cards else 1})
    for name in ("cli", "configs", "four_cards"):
        monkeypatch.setattr(cs, f"phase_{name}",
                            lambda name=name: ran.append(name))
    cs.main(["--four-cards"] if four_cards else [])
    assert ran == (["four_cards"] if four_cards else ["cli", "configs"])
    assert ran == cs.select_phases(four_cards)
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {
        "platform": "gpu", "kind": "test", "count": 4 if four_cards else 1}}

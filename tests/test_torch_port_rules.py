"""Guards on the port's boundary with the JAX package.

``repro_torch`` imports torch and never jax, jaxlib or anything of
``repro``; its entry points default to the card and raise without one
instead of sliding onto the CPU.
"""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch                                              # noqa: E402

PKG = Path(repro_torch.__file__).parent


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)],
                                                        "repro_torch."))


def test_import_leaves_no_jax_and_no_repro_in_sys_modules():
    mods = _submodules()
    assert "repro_torch.serving.engine" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(PKG.parent)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_never_import_jax_or_repro():
    pat = re.compile(r"^\s*(import\s+(jax|jaxlib|repro)\b|"
                     r"from\s+(jax|jaxlib|repro)(\.|\s))", re.M)
    for path in PKG.rglob("*.py"):
        assert not pat.search(path.read_text()), path


def test_engine_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.serving.engine import ServingEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(registry.get_smoke("phi4-mini-3.8b"))
    engine = ServingEngine(registry.get_smoke("phi4-mini-3.8b"),
                           device="cpu", num_slots=1, prompt_len=8,
                           max_new_tokens=2)
    assert engine.device.type == "cpu"


def test_bridge_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    import numpy as np
    from repro_torch import bridge
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"a": {"b": np.ones((2, 3), np.float32)}}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.to_torch(tree)
    assert bridge.to_torch(tree, device="cpu")["a"]["b"].device.type == "cpu"


def test_cli_raises_without_a_card_unless_cpu_is_asked_for(monkeypatch,
                                                           capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1"])
    serve.main(["--smoke", "--device", "cpu", "--requests", "3",
                "--prompt-len", "8", "--gen", "4", "--slots", "2"])
    out = capsys.readouterr().out
    assert "[serve:continuous] completed 3 requests" in out
    assert "| requests | 3 |" in out

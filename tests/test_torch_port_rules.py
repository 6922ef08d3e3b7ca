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
    smoke = PKG.parents[1] / "chip_smoke.py"
    for path in [*PKG.rglob("*.py"), smoke]:
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


def test_training_raises_without_a_card_unless_cpu_is_asked_for(
        monkeypatch, capsys):
    from repro_torch.configs import registry
    from repro_torch.configs.base import OptimizerConfig
    from repro_torch.data.tokens import TokenPipeline
    from repro_torch.launch import train
    from repro_torch.models import params as pr
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime import steps
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_smoke("phi4-mini-3.8b")
    par, ocfg = registry.get_parallel("phi4-mini-3.8b"), OptimizerConfig()
    params = pr.init_params(tfm.lm_schema(cfg), torch.Generator(),
                            cfg.param_dtype, "cpu")
    opt = steps.init_opt_state(cfg, ocfg, device="cpu")
    batch = TokenPipeline(cfg.vocab_size, 8, 2).batch(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.train_step(cfg, par, ocfg, params, opt, batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.init_opt_state(cfg, ocfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--smoke", "--steps", "1"])
    _, _, m = steps.train_step(cfg, par, ocfg, params, opt, batch,
                               device="cpu")
    assert m["loss"].device.type == "cpu"
    train.main(["--smoke", "--device", "cpu", "--steps", "2", "--seq", "8",
                "--batch", "2"])
    assert "[train] loss " in capsys.readouterr().out

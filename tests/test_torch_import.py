"""The port stands alone: apex_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package, and the port's entry points never drop to the CPU
on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "apex_tpu_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "apex_tpu")


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_module_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for name in ('jax', 'jaxlib', 'apex_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import apex_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "apex_tpu_torch.__path__, 'apex_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "for want in ('serving.engine', 'inference.engine', "
        "'inference.sampling', 'ops.fused_verify', 'spec.drafter', "
        "'spec.tree', 'models.t5', 'models.bert', 'models.convert', "
        "'amp.policy', 'amp.lists', 'amp.scaler', 'amp.master', "
        "'amp.frontend', 'transformer.amp', 'utils.pytree'):\n"
        "    assert 'apex_tpu_torch.' + want in mods, want\n"
        "assert not any(k.split('.')[0] in ('jax', 'apex_tpu') and "
        "sys.modules[k] is not None for k in list(sys.modules))\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 18


def test_env_report_fields():
    import apex_tpu_torch

    rep = apex_tpu_torch.env_report()
    assert set(rep) == {"torch", "cuda", "nvcc", "gpu", "nvidia_smi"}
    assert rep["torch"] == torch.__version__


def test_entry_points_default_to_the_card(monkeypatch):
    from apex_tpu_torch.inference import DecodeEngine
    from apex_tpu_torch.models.convert import params_from_jax
    from apex_tpu_torch.models.gpt import GPTConfig, GPTModel
    from apex_tpu_torch.serving.engine import ServingEngine
    from apex_tpu_torch.spec import ModelDrafter

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = GPTModel(GPTConfig(vocab_size=64, max_seq_len=32,
                               hidden_size=32, num_layers=1, num_heads=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, num_slots=1, block_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax({}, model.config)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DecodeEngine(model, max_seq_len=128)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ModelDrafter(model, {}, k=2)
    eng = ServingEngine(model, num_slots=1, block_size=16, device="cpu")
    assert eng.init_pool()["k"].device.type == "cpu"

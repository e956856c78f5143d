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
        "for name in ('jax', 'jaxlib', 'apex_tpu', 'triton'):\n"
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
        "'amp.frontend', 'transformer.amp', 'utils.pytree', "
        "'optimizers._fused', 'optimizers.multi_tensor', "
        "'optimizers.fused_adam', 'optimizers.fused_lamb', "
        "'optimizers.fused_mixed_precision_lamb', 'optimizers.fused_sgd', "
        "'optimizers.fused_novograd', 'optimizers.fused_adagrad', "
        "'parallel.larc', 'fp16_utils.loss_scaler', 'fp16_utils.fp16util', "
        "'fp16_utils.fp16_optimizer', 'utils.logging', 'monitor', "
        "'monitor.registry', 'monitor.trace', 'monitor.histogram', "
        "'monitor.spans', 'serving.telemetry', 'ops.focal_loss', "
        "'contrib', 'contrib.xentropy', 'contrib.focal_loss', "
        "'contrib.fmha', 'contrib.multihead_attn', 'contrib.layer_norm', "
        "'contrib.transducer', 'contrib.transducer.transducer', "
        "'contrib.sparsity', 'contrib.sparsity.masklib', "
        "'contrib.sparsity.permutation', 'contrib.sparsity.asp', "
        "'ops.batch_norm', 'parallel.sync_batchnorm', 'models.resnet', "
        "'contrib.conv_bias_relu', 'contrib.bottleneck', "
        "'contrib.groupbn', 'rnn', 'rnn.cells', 'rnn.backend', "
        "'reparameterization'):\n"
        "    assert 'apex_tpu_torch.' + want in mods, want\n"
        "assert not any(k.split('.')[0] in ('jax', 'apex_tpu', 'triton') "
        "and sys.modules[k] is not None for k in list(sys.modules))\n"
        "from apex_tpu_torch.ops import _build\n"
        "assert _build.library.cache_info().currsize == 0\n"
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
    from apex_tpu_torch.models.resnet import ResNet50, ResNetConfig
    from apex_tpu_torch.parallel import BatchNormState, SyncBatchNorm
    from apex_tpu_torch.rnn import LSTMCell
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResNet50(ResNetConfig(layers=(1, 1, 1, 1))).init(torch.Generator())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchNormState.create(4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyncBatchNorm(4).init()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LSTMCell(3, 4).init(torch.Generator())
    eng = ServingEngine(model, num_slots=1, block_size=16, device="cpu")
    assert eng.init_pool()["k"].device.type == "cpu"


def test_new_entry_points_export_the_reference_names():
    from apex_tpu_torch import inference, monitor, serving
    from apex_tpu_torch import models, parallel, reparameterization, rnn
    from apex_tpu_torch.contrib import bottleneck, conv_bias_relu, groupbn
    from apex_tpu_torch.contrib import fmha, focal_loss, multihead_attn
    from apex_tpu_torch.contrib import layer_norm, sparsity, transducer
    from apex_tpu_torch.contrib import xentropy
    from apex_tpu_torch.ops import attention

    for mod, names in ((xentropy, ("SoftmaxCrossEntropyLoss",
                                   "softmax_cross_entropy_loss")),
                       (focal_loss, ("focal_loss",)),
                       (fmha, ("fmha_varlen", "FMHAFun", "fmha", "FMHA")),
                       (multihead_attn, ("SelfMultiheadAttn",
                                         "EncdecMultiheadAttn")),
                       (layer_norm, ("FastLayerNorm", "fast_layer_norm")),
                       (transducer, ("TransducerJoint", "TransducerLoss",
                                     "transducer_joint", "transducer_loss")),
                       (sparsity, ("ASP", "create_mask", "mask_2to4_best",
                                   "greedy_swap_search", "exhaustive_search",
                                   "search_for_good_permutation",
                                   "sum_after_2_to_4", "apply_permutation",
                                   "invert_permutation")),
                       (attention, ("seed_from_key",)),
                       (conv_bias_relu, ("conv_bias", "conv_bias_relu",
                                         "conv_bias_mask_relu",
                                         "conv_frozen_scale_bias_relu")),
                       (bottleneck, ("Bottleneck",)),
                       (groupbn, ("BatchNorm2d_NHWC",)),
                       (models, ("ResNet50", "ResNetConfig")),
                       (parallel, ("SyncBatchNorm", "BatchNormState",
                                   "sync_batch_norm", "LARC")),
                       (rnn, ("RNN", "stacked_rnn", "bidirectional",
                              "LSTMCell", "GRUCell", "RNNTanhCell",
                              "RNNReLUCell", "mLSTMCell", "LSTM", "GRU",
                              "ReLU", "Tanh", "mLSTM")),
                       (reparameterization, (
                           "weight_norm_decompose", "weight_norm_compose",
                           "apply_weight_norm", "remove_weight_norm"))):
        for name in names:
            assert hasattr(mod, name), (mod.__name__, name)

    assert callable(inference.jit_encoder)
    assert serving.ServeTelemetry.__module__ == "apex_tpu_torch.serving.telemetry"
    for name in ("enable", "disable", "enabled", "get_registry",
                 "enable_from_env", "MetricsRegistry", "SCHEMA_VERSION",
                 "StreamingHistogram", "span", "span_path", "trace",
                 "chrome_trace", "serve_attribution", "trace_context",
                 "new_trace_id", "current_trace_id", "flight_dump",
                 "check_record_honesty", "emit_serve_window"):
        assert hasattr(monitor, name), name
    # what the reference's monitor has and the port does not yet: absent,
    # not stubbed
    for name in ("hooks", "validate_jsonl", "aggregate", "collective_span"):
        assert not hasattr(monitor, name), name
    # what needs a process group comes with the multi-GPU surface: absent,
    # not stubbed
    for mod, name in ((bottleneck, "SpatialBottleneck"),
                      (bottleneck, "halo_exchange"),
                      (bottleneck, "spatial_conv3x3"),
                      (groupbn, "split_data_axis_for_bn"),
                      (parallel, "create_syncbn_process_group")):
        assert not hasattr(mod, name), name

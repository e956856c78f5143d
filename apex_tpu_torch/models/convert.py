"""The weight bridge between the reference's parameter trees and the port's.

``apex_tpu``'s ``GPTModel.init`` returns a pytree whose ``layers`` leaves
are stacked ``[num_layers, ...]``; handed over as numpy arrays (no JAX
import here), :func:`params_from_jax` unstacks them into the port's list
of per-layer dicts, and :func:`params_to_jax` stacks the port's params (or
gradients, which share their layout) back into the reference's tree.
:func:`t5_params_from_jax` and :func:`t5_params_to_jax` do the same for
``EncoderDecoderModel``'s stacked ``encoder`` and ``decoder``, and
:func:`bert_params_from_jax` and :func:`bert_params_to_jax` for
``BertModel``'s stacked ``layers``; :func:`norm_from_jax` loads a
reference norm's ``init()`` dict into a :class:`~apex_tpu_torch.ops.
layer_norm.FusedLayerNorm` or :class:`~apex_tpu_torch.ops.layer_norm.
FusedRMSNorm`, and :func:`dense_from_jax`, :func:`dense_gelu_dense_from_jax`
and :func:`mlp_from_jax` load ``FusedDense``'s, ``FusedDenseGeluDense``'s
and ``MLP``'s into the port's modules of the same names.
Weights keep their ``(out, in)`` layout, which is already PyTorch's. The
tests feed both packages the same weights this way, and compare gradients
and optimizer state leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from apex_tpu_torch.models.bert import BertConfig
from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.models.t5 import DEC_LAYER, ENC_LAYER, T5Config
from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.fused_dense import FusedDense, FusedDenseGeluDense
from apex_tpu_torch.ops.layer_norm import FusedLayerNorm
from apex_tpu_torch.ops.mlp import MLP


def _tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    return t.to(device)


def _expect(name: str, t, shape, config: str = "GPTConfig") -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)} for this "
                         f"{config}, got {tuple(t.shape)}")


def params_from_jax(tree: Dict, config: GPTConfig, *,
                    device: Optional[Union[str, torch.device]] = None
                    ) -> Dict[str, object]:
    """``GPTModel.init``'s tree (numpy leaves: ``embedding.weight``,
    ``pos_embedding``, stacked ``layers``, ``lnf_w``/``lnf_b``) → the
    port's parameter dict on ``device`` (default: the card). Every shape
    is checked against ``config``."""
    dev = _backend.resolve_device(device)
    c = config
    H, L = c.hidden_size, c.num_layers
    out = {
        "embedding": {"weight": _tensor(tree["embedding"]["weight"], dev)},
        "pos_embedding": _tensor(tree["pos_embedding"], dev),
        "lnf_w": _tensor(tree["lnf_w"], dev),
        "lnf_b": _tensor(tree["lnf_b"], dev),
    }
    _expect("embedding.weight", out["embedding"]["weight"],
            (c.vocab_size, H))
    _expect("pos_embedding", out["pos_embedding"], (c.max_seq_len, H))
    stacked = {
        name: ({k: _tensor(v, dev) for k, v in leaf.items()}
               if isinstance(leaf, dict) else _tensor(leaf, dev))
        for name, leaf in tree["layers"].items()}
    shapes = {"ln1_w": (H,), "ln1_b": (H,), "ln2_w": (H,), "ln2_b": (H,),
              "qkv.weight": (c.qkv_features, H), "qkv.bias": (c.qkv_features,),
              "attn_out.weight": (H, H), "attn_out.bias": (H,),
              "mlp_up.weight": (c.ffn, H), "mlp_up.bias": (c.ffn,),
              "mlp_down.weight": (H, c.ffn), "mlp_down.bias": (H,)}
    for key, shape in shapes.items():
        mod, _, leaf = key.partition(".")
        t = stacked[mod][leaf] if leaf else stacked[mod]
        _expect(f"layers.{key}", t, (L, *shape))
    out["layers"] = [
        {name: ({k: v[i] for k, v in leaf.items()}
                if isinstance(leaf, dict) else leaf[i])
         for name, leaf in stacked.items()}
        for i in range(L)]
    return out


def _array(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 widens to float32, which holds it exactly
    (numpy has no bfloat16 of its own)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def params_to_jax(params: Dict[str, object],
                  config: GPTConfig) -> Dict[str, object]:
    """The port's parameter (or gradient) dict → the reference's tree:
    numpy leaves, ``layers`` stacked ``[num_layers, ...]``. bf16 leaves
    come back as float32 (exact). Shapes are checked against ``config``."""
    c = config
    layers = params["layers"]
    if len(layers) != c.num_layers:
        raise ValueError(f"expected {c.num_layers} layers for this "
                         f"GPTConfig, got {len(layers)}")

    def stack(name, leaf=None):
        return np.stack([_array(lay[name] if leaf is None else
                                lay[name][leaf]) for lay in layers])

    stacked = {}
    for name, first in layers[0].items():
        stacked[name] = ({k: stack(name, k) for k in first}
                         if isinstance(first, dict) else stack(name))
    out = {"embedding": {"weight": _array(params["embedding"]["weight"])},
           "pos_embedding": _array(params["pos_embedding"]),
           "layers": stacked,
           "lnf_w": _array(params["lnf_w"]),
           "lnf_b": _array(params["lnf_b"])}
    H = c.hidden_size
    _expect("embedding.weight", out["embedding"]["weight"],
            (c.vocab_size, H))
    _expect("pos_embedding", out["pos_embedding"], (c.max_seq_len, H))
    _expect("layers.qkv.weight", stacked["qkv"]["weight"],
            (c.num_layers, c.qkv_features, H))
    return out


def _t5_shapes(c: T5Config) -> Dict[str, tuple]:
    """Every leaf's shape: top-level names, then ``encoder.*`` and
    ``decoder.*`` per layer."""
    H, Fh, nb = c.hidden_size, c.ffn, c.relative_num_buckets
    layer = {"ln1_w": (H,), "ln1_b": (H,), "ln2_w": (H,), "ln2_b": (H,),
             "ln_x_w": (H,), "ln_x_b": (H,), "qkv": (3 * H, H),
             "attn_out": (H, H), "xq": (H, H), "xkv": (2 * H, H),
             "x_out": (H, H), "mlp_up": (Fh, H), "mlp_down": (H, Fh)}
    out = {"embedding": (c.vocab_size, H), "ln_enc_w": (H,),
           "ln_enc_b": (H,), "ln_dec_w": (H,), "ln_dec_b": (H,)}
    if c.position_encoding == "relative":
        out["rel_bias_enc"] = out["rel_bias_dec"] = (nb, c.num_heads)
    else:
        out["pos_embedding"] = (c.max_seq_len, H)
    out.update({f"encoder.{k}": layer[k] for k in ENC_LAYER})
    out.update({f"decoder.{k}": layer[k] for k in DEC_LAYER})
    return out


def t5_params_from_jax(tree: Dict, config: T5Config, *,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Dict[str, object]:
    """``EncoderDecoderModel.init``'s tree (numpy leaves, ``encoder`` and
    ``decoder`` stacked ``[layers, ...]``) → the port's parameter dict on
    ``device`` (default: the card), ``encoder``/``decoder`` as lists of
    per-layer dicts. Every shape is checked against ``config``."""
    dev = _backend.resolve_device(device)
    c = config
    shapes = _t5_shapes(c)
    out: Dict[str, object] = {}
    for name, shape in shapes.items():
        if "." not in name:
            out[name] = _tensor(tree[name], dev)
            _expect(name, out[name], shape, "T5Config")
    for stack, names, n in (("encoder", ENC_LAYER, c.num_encoder_layers),
                            ("decoder", DEC_LAYER, c.num_decoder_layers)):
        stacked = {k: _tensor(tree[stack][k], dev) for k in names}
        for k, t in stacked.items():
            _expect(f"{stack}.{k}", t, (n, *shapes[f"{stack}.{k}"]),
                    "T5Config")
        out[stack] = [{k: t[i] for k, t in stacked.items()}
                      for i in range(n)]
    return out


def t5_params_to_jax(params: Dict[str, object],
                     config: T5Config) -> Dict[str, object]:
    """The port's T5 parameter (or gradient) dict → the reference's tree:
    numpy leaves, ``encoder``/``decoder`` stacked ``[layers, ...]``. bf16
    leaves come back as float32 (exact). Shapes are checked against
    ``config``."""
    c = config
    shapes = _t5_shapes(c)
    out: Dict[str, object] = {}
    for name, shape in shapes.items():
        if "." not in name:
            out[name] = _array(params[name])
            _expect(name, out[name], shape, "T5Config")
    for stack, names, n in (("encoder", ENC_LAYER, c.num_encoder_layers),
                            ("decoder", DEC_LAYER, c.num_decoder_layers)):
        layers = params[stack]
        if len(layers) != n:
            raise ValueError(f"expected {n} {stack} layers for this "
                             f"T5Config, got {len(layers)}")
        out[stack] = {k: np.stack([_array(lay[k]) for lay in layers])
                      for k in names}
        for k, t in out[stack].items():
            _expect(f"{stack}.{k}", t, (n, *shapes[f"{stack}.{k}"]),
                    "T5Config")
    return out


def _bert_shapes(c: BertConfig) -> Dict[str, tuple]:
    """Every leaf's shape: top-level names, then ``layers.*`` per layer."""
    H, Fh = c.hidden_size, c.ffn
    return {
        "embedding.weight": (c.vocab_size, H),
        "pos_embedding": (c.max_seq_len, H),
        "type_embedding": (c.num_token_types, H),
        "ln_emb_w": (H,), "ln_emb_b": (H,),
        "pooler_w": (H, H), "pooler_b": (H,),
        "layers.qkv.weight": (3 * H, H), "layers.qkv.bias": (3 * H,),
        "layers.attn_out.weight": (H, H), "layers.attn_out.bias": (H,),
        "layers.ln1_w": (H,), "layers.ln1_b": (H,),
        "layers.mlp_up.weight": (Fh, H), "layers.mlp_up.bias": (Fh,),
        "layers.mlp_down.weight": (H, Fh), "layers.mlp_down.bias": (H,),
        "layers.ln2_w": (H,), "layers.ln2_b": (H,),
    }


def _leaf(tree, dotted: str):
    for part in dotted.split("."):
        tree = tree[part]
    return tree


def bert_params_from_jax(tree: Dict, config: BertConfig, *,
                         device: Optional[Union[str, torch.device]] = None
                         ) -> Dict[str, object]:
    """``BertModel.init``'s tree (numpy leaves, ``layers`` stacked
    ``[num_layers, ...]``) → the port's parameter dict on ``device``
    (default: the card), ``layers`` as a list of per-layer dicts. Every
    shape is checked against ``config``."""
    dev = _backend.resolve_device(device)
    c = config
    out: Dict[str, object] = {"embedding": {}, "layers": []}
    stacked: Dict[str, torch.Tensor] = {}
    for name, shape in _bert_shapes(c).items():
        t = _tensor(_leaf(tree, name), dev)
        if name.startswith("layers."):
            _expect(name, t, (c.num_layers, *shape), "BertConfig")
            stacked[name[len("layers."):]] = t
        else:
            _expect(name, t, shape, "BertConfig")
            if name == "embedding.weight":
                out["embedding"]["weight"] = t
            else:
                out[name] = t
    for i in range(c.num_layers):
        layer: Dict[str, object] = {}
        for name, t in stacked.items():
            mod, _, leaf = name.partition(".")
            if leaf:
                layer.setdefault(mod, {})[leaf] = t[i]
            else:
                layer[mod] = t[i]
        out["layers"].append(layer)
    return out


def bert_params_to_jax(params: Dict[str, object],
                       config: BertConfig) -> Dict[str, object]:
    """The port's BERT parameter (or gradient) dict → the reference's
    tree: numpy leaves, ``layers`` stacked ``[num_layers, ...]``. bf16
    leaves come back as float32 (exact). Shapes are checked against
    ``config``."""
    c = config
    layers = params["layers"]
    if len(layers) != c.num_layers:
        raise ValueError(f"expected {c.num_layers} layers for this "
                         f"BertConfig, got {len(layers)}")
    out: Dict[str, object] = {"embedding": {}, "layers": {}}
    for name, shape in _bert_shapes(c).items():
        if name.startswith("layers."):
            sub = name[len("layers."):]
            a = np.stack([_array(_leaf(lay, sub)) for lay in layers])
            _expect(name, a, (c.num_layers, *shape), "BertConfig")
            mod, _, leaf = sub.partition(".")
            if leaf:
                out["layers"].setdefault(mod, {})[leaf] = a
            else:
                out["layers"][mod] = a
        else:
            a = _array(_leaf(params, name))
            _expect(name, a, shape, "BertConfig")
            if name == "embedding.weight":
                out["embedding"]["weight"] = a
            else:
                out[name] = a
    return out


def norm_from_jax(tree: Dict, module: FusedLayerNorm) -> FusedLayerNorm:
    """The reference's ``FusedLayerNorm.init()`` / ``FusedRMSNorm.init()``
    dict (numpy leaves: ``weight``, plus ``bias`` for LayerNorm; empty
    without the affine) copied into ``module``'s Parameters in place, on
    their device and in their dtype. Names and shapes are checked."""
    want = set()
    if module.elementwise_affine:
        want = {"weight"} if module.rms else {"weight", "bias"}
    return _load_module(tree, module, want)


def _load_module(tree: Dict, module: torch.nn.Module, want) -> torch.nn.Module:
    """Copy ``tree``'s leaves, exactly the names ``want``, into
    ``module``'s Parameters of those names, in place, on their device and
    in their dtype; names and shapes are checked."""
    if set(tree) != set(want):
        raise ValueError(f"expected the leaves {sorted(want)} for this "
                         f"{type(module).__name__}, got {sorted(tree)}")
    with torch.no_grad():
        for name in sorted(want):
            p = getattr(module, name)
            t = _tensor(tree[name], p.device)
            _expect(name, t, p.shape, type(module).__name__)
            p.copy_(t.to(p.dtype))
    return module


def dense_from_jax(tree: Dict, module: FusedDense) -> FusedDense:
    """The reference's ``FusedDense.init()`` dict (numpy leaves:
    ``weight`` (out, in), plus ``bias`` when the layer has one) copied
    into ``module``'s Parameters in place."""
    want = {"weight"} if module.bias is None else {"weight", "bias"}
    return _load_module(tree, module, want)


def dense_gelu_dense_from_jax(tree: Dict, module: FusedDenseGeluDense
                              ) -> FusedDenseGeluDense:
    """The reference's ``FusedDenseGeluDense.init()`` dict (``weight1``,
    ``bias1``, ``weight2``, ``bias2``) copied into ``module`` in place."""
    return _load_module(tree, module,
                        {"weight1", "bias1", "weight2", "bias2"})


def mlp_from_jax(tree: Dict, module: MLP) -> MLP:
    """The reference's ``MLP.init()`` dict (``weight_i`` (out, in) and
    ``bias_i`` per layer) copied into ``module`` in place."""
    return _load_module(tree, module, {
        f"{kind}_{i}" for i in range(module.num_layers)
        for kind in ("weight", "bias")})

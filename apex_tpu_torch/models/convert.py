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
and ``MLP``'s into the port's modules of the same names, and
:func:`self_mha_from_jax` and :func:`encdec_mha_from_jax` contrib's
``SelfMultiheadAttn``'s and ``EncdecMultiheadAttn``'s;
:func:`optimizer_state_from_jax` gives a reference optimizer's state as
the port optimizer's, and :func:`serving_pool_from_jax` a reference
serving engine's block pool (float, or int8/fp8 with its scale planes) as
the port's; :func:`resnet_params_from_jax` and :func:`resnet_params_to_jax`
move ``ResNet50``'s tree, and :func:`bn_state_from_jax` its batch-norm
states.
Dense weights keep their ``(out, in)`` layout, which is already
PyTorch's. The ResNet's are the one place where the layouts differ: a
reference conv weight is HWIO, the port's PyTorch's (out, in, kh, kw), and
the reference's ``fc_w`` is (in, classes), the port's (classes, in); the
ResNet functions transpose them both ways. The tests feed both packages
the same weights this way, and compare gradients and optimizer state leaf
by leaf.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from apex_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                   SelfMultiheadAttn)
from apex_tpu_torch.models.bert import BertConfig
from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.models.resnet import ResNet50, ResNetConfig
from apex_tpu_torch.models.t5 import DEC_LAYER, ENC_LAYER, T5Config
from apex_tpu_torch.ops import _backend
from apex_tpu_torch.ops.fused_dense import FusedDense, FusedDenseGeluDense
from apex_tpu_torch.ops.layer_norm import FusedLayerNorm
from apex_tpu_torch.ops.mlp import MLP
from apex_tpu_torch.optimizers import (FusedAdagrad, FusedAdam, FusedLAMB,
                                       FusedMixedPrecisionLamb, FusedNovoGrad,
                                       FusedSGD)
from apex_tpu_torch.optimizers.multi_tensor import (make_layout,
                                                    unflatten_from_chunks)
from apex_tpu_torch.parallel.sync_batchnorm import BatchNormState


def _tensor(a, device: torch.device) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: same bits as torch's
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    elif arr.dtype.name == "float8_e4m3fn":  # ml_dtypes' fp8: torch's bits
        t = torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
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


def self_mha_from_jax(tree: Dict, module: SelfMultiheadAttn
                      ) -> SelfMultiheadAttn:
    """The reference's ``SelfMultiheadAttn.init()`` dict (numpy leaves:
    ``qkv_weight`` or ``q_weight``/``k_weight``/``v_weight``,
    ``out_weight``, their biases with ``bias``, ``ln_weight``/``ln_bias``
    with ``include_norm_add``) copied into ``module``'s Parameters of the
    same names, in place."""
    return _load_module(tree, module, _mha_leaves(module))


def encdec_mha_from_jax(tree: Dict, module: EncdecMultiheadAttn
                        ) -> EncdecMultiheadAttn:
    """The reference's ``EncdecMultiheadAttn.init()`` dict (``q_weight``,
    ``kv_weight``, ``out_weight``, their biases, the norm's) copied into
    ``module`` in place."""
    return _load_module(tree, module, _mha_leaves(module))


def _mha_leaves(module) -> set:
    kinds = ("weight", "bias") if module.bias else ("weight",)
    want = {f"{n}_{k}" for n in module.projections for k in kinds}
    if module.include_norm_add:
        want |= {"ln_weight", "ln_bias"}
    return want


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


# --- optimizer state ---------------------------------------------------------

def _field(state, name: str):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def _take(ref, i: int, path: str):
    """Layer ``i`` of a stacked reference subtree: index ``i`` of every
    leaf. A 0-dim leaf (a per-tensor scalar of a stacked leaf) has no
    layer to take."""
    if isinstance(ref, dict):
        return {k: _take(v, i, f"{path}.{k}") for k, v in ref.items()}
    if ref.ndim == 0:
        raise ValueError(
            f"{path}: the reference keeps one per-tensor scalar for all "
            f"layers of this stacked leaf; it cannot become one a layer — "
            f"run the reference on the per-layer tree (params_to_jax's "
            f"inverse layout)")
    return ref[i]


def _pairs(ref, port, path: str = "params"):
    """(port tensor, reference leaf) in the port tree's leaf order (dict
    keys sorted). Where the port keeps a list of layers and the reference
    a stacked subtree, layer i takes index i of every reference leaf."""
    if isinstance(port, torch.Tensor):
        return [(port, ref)]
    if isinstance(port, dict):
        return [pr for k in sorted(port)
                for pr in _pairs(ref[k], port[k], f"{path}.{k}")]
    if isinstance(ref, (list, tuple)):
        return [pr for i, (r, p) in enumerate(zip(ref, port))
                for pr in _pairs(r, p, f"{path}.{i}")]
    return [pr for i, p in enumerate(port)
            for pr in _pairs(_take(ref, i, path), p, f"{path}.{i}")]


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_torch_tree(v) for v in tree]
    return _tensor(tree, torch.device("cpu"))


def optimizer_state_from_jax(state, optimizer: torch.optim.Optimizer,
                             params, jax_params) -> Dict[torch.Tensor, dict]:
    """The reference optimizer's state as the port optimizer's per-tensor
    state: ``opt.state.update(optimizer_state_from_jax(...))``.

    ``state``: the reference's state with numpy leaves (``jax.tree.map(
    np.asarray, state)``, or a dict of the same fields): a
    ``PerTensorState`` (``count``, ``buffers``, ``scalars``) for
    ``fused_adam``, ``fused_lamb``, ``fused_sgd``, ``fused_novograd`` and
    ``fused_adagrad``, or a ``MixedPrecisionLambState`` (``count``, the
    chunked ``master``/``m``/``v`` and its ``layout.chunk_size``).
    ``optimizer`` names the port's state (its type); ``params`` is the
    port's tree it steps over; ``jax_params`` the tree the reference was
    initialised with (numpy leaves), stacked or per layer: where it
    stacks layers that the port keeps apart, each layer takes its slice,
    and a per-tensor scalar (NovoGrad's ``v``) raises ``ValueError``.
    Tensors land fp32 on each parameter's device."""
    count = int(np.asarray(_field(state, "count")))
    if isinstance(optimizer, FusedMixedPrecisionLamb):
        skeleton = _torch_tree(jax_params)
        layout = make_layout(skeleton, int(getattr(
            _field(state, "layout"), "chunk_size", 1024)))
        trees = {name: unflatten_from_chunks(
            _tensor(_field(state, key), torch.device("cpu")), layout)
            for name, key in (("master", "master"), ("exp_avg", "m"),
                              ("exp_avg_sq", "v"))}
    else:
        names = {FusedAdam: {"m": "exp_avg", "v": "exp_avg_sq"},
                 FusedLAMB: {"m": "exp_avg", "v": "exp_avg_sq"},
                 FusedSGD: {"momentum": "momentum_buffer"},
                 FusedNovoGrad: {"m": "exp_avg", "v": "exp_avg_sq"},
                 FusedAdagrad: {"h": "sum"}}[type(optimizer)]
        trees = {}
        for kind in ("buffers", "scalars"):
            for key, tree in (_field(state, kind) or {}).items():
                trees[names[key]] = tree
    out = {p: {"step": count} for p, _ in _pairs(jax_params, params)}
    for name, tree in trees.items():
        for p, ref in _pairs(tree, params):
            t = _tensor(ref, p.device).to(torch.float32)
            if t.ndim and t.shape != p.shape:
                raise ValueError(f"{name}: reference shape "
                                 f"{tuple(t.shape)} for a tensor of "
                                 f"{tuple(p.shape)}")
            out[p][name] = t
    return out


#: a serving pool's cell dtypes the bridge takes: the float pools' and the
#: quantized ones' (``kv_dtype="int8"`` / ``"fp8_e4m3"``)
_POOL_DTYPES = ("float32", "bfloat16", "float16", "int8", "float8_e4m3fn")


def serving_pool_from_jax(pool: Dict, *,
                          device: Union[str, torch.device] = "cpu"
                          ) -> Dict[str, torch.Tensor]:
    """A reference ``ServingEngine``'s block pool (numpy leaves: ``{k: np.
    asarray(v) for k, v in pool.items()}``) as the port's: ``k``/``v``
    (layers, num_blocks, kv_heads, block_size, head_dim) float, int8 or
    float8_e4m3fn cells, and with a quantized pool ``k_scale``/``v_scale``
    (layers, num_blocks, block_size) fp32. The bits are kept."""
    device = torch.device(device)
    quant = "k_scale" in pool or "v_scale" in pool
    names = ("k", "v", "k_scale", "v_scale") if quant else ("k", "v")
    if set(pool) != set(names):
        raise ValueError(f"a serving pool has {names}; got {sorted(pool)}")
    out = {name: _tensor(pool[name], device) for name in names}
    k = out["k"]
    if k.ndim != 5 or out["v"].shape != k.shape or out["v"].dtype != k.dtype:
        raise ValueError(f"k/v must be one (layers, num_blocks, kv_heads, "
                         f"block_size, head_dim) shape and dtype; got "
                         f"{tuple(k.shape)} {k.dtype}, "
                         f"{tuple(out['v'].shape)} {out['v'].dtype}")
    if str(k.dtype).split(".")[-1] not in _POOL_DTYPES \
            or quant != (k.element_size() == 1):
        raise ValueError(f"k/v cells of {k.dtype} with{'' if quant else 'out'}"
                         f" scale planes: a quantized pool has 1-byte cells "
                         f"and both scales, a float pool neither")
    for name in names[2:]:
        want = (k.shape[0], k.shape[1], k.shape[3])
        if tuple(out[name].shape) != want \
                or out[name].dtype != torch.float32:
            raise ValueError(f"{name} must be {want} float32; got "
                             f"{tuple(out[name].shape)} {out[name].dtype}")
    return out


# --- ResNet-50 ----------------------------------------------------------------

def _resnet_walk(tree, shapes, path, leaf_fn):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            raise ValueError(f"{path or 'params'}: expected keys "
                             f"{sorted(shapes)} for this ResNetConfig, got "
                             f"{sorted(tree) if isinstance(tree, dict) else type(tree)}")
        return {k: _resnet_walk(tree[k], shapes[k], f"{path}.{k}".strip("."),
                                leaf_fn) for k in shapes}
    return leaf_fn(path, tree, shapes)


def _resnet_perm(path: str):
    """The axes that take a reference leaf to the port's layout (None: as
    it is): HWIO → (out, in, kh, kw); fc_w (in, classes) → (classes, in)."""
    name = path.rsplit(".", 1)[-1]
    if name.startswith("conv"):
        return (3, 2, 0, 1)
    if name == "fc_w":
        return (1, 0)
    return None


def resnet_params_from_jax(tree: Dict, config: ResNetConfig, *,
                           device: Optional[Union[str, torch.device]] = None
                           ) -> Dict[str, object]:
    """``ResNet50.init``'s params (numpy leaves) → the port's tree on
    ``device`` (default: the card), conv weights and ``fc_w`` transposed
    to PyTorch's layout; every shape checked against ``config``."""
    dev = _backend.resolve_device(device)

    def leaf(path, a, shape):
        perm = _resnet_perm(path)
        arr = np.asarray(a)
        if perm is not None:
            arr = np.transpose(arr, perm)
        t = _tensor(np.ascontiguousarray(arr), dev)
        _expect(path, t, shape, "ResNetConfig")
        return t

    return _resnet_walk(tree, ResNet50(config).param_shapes(), "", leaf)


def resnet_params_to_jax(params: Dict[str, object],
                         config: ResNetConfig) -> Dict[str, object]:
    """The port's ResNet params (or gradients, which share their layout)
    → the reference's tree: numpy leaves, conv weights HWIO and ``fc_w``
    (in, classes); bf16 leaves come back as float32 (exact)."""
    def leaf(path, t, shape):
        _expect(path, t, shape, "ResNetConfig")
        perm = _resnet_perm(path)
        arr = _array(t)
        if perm is not None:
            arr = np.ascontiguousarray(np.transpose(
                arr, np.argsort(perm)))
        return arr

    return _resnet_walk(params, ResNet50(config).param_shapes(), "", leaf)


def bn_state_from_jax(state, *,
                      device: Optional[Union[str, torch.device]] = None):
    """A reference tree of ``BatchNormState``s (numpy leaves; nested
    dicts, as ``ResNet50.init``'s state, or one state) → the port's
    :class:`~apex_tpu_torch.parallel.sync_batchnorm.BatchNormState`s on
    ``device`` (default: the card)."""
    dev = _backend.resolve_device(device)
    if isinstance(state, dict):
        return {k: bn_state_from_jax(v, device=dev) for k, v in state.items()}
    return BatchNormState(
        running_mean=_tensor(state.running_mean, dev),
        running_var=_tensor(state.running_var, dev),
        num_batches_tracked=_tensor(
            np.asarray(state.num_batches_tracked).astype(np.int32), dev))

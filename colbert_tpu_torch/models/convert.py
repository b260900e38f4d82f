"""Checkpoint conversion into the port's ``ColbertModel`` and
``CrossEncoderModel`` state dicts.

Two sources:

* the JAX package's parameter tree (nested dicts of numpy arrays, as
  ``colbert_tpu.models.ColbertModel.init`` or a checkpoint gives it):
  :func:`state_dict_from_jax_params`.  Dense kernels are stored (in, out) by
  flax and (out, in) by torch, so they are transposed, as
  ``colbert_tpu/models/convert.py:47-80`` does the other way;
* the reference ``pytorch.bin`` layout (``model.*`` BERT keys +
  ``linear.weight``), which ``colbert_params_to_torch_state_dict`` writes
  from a JAX checkpoint: :func:`state_dict_from_reference`, and its inverse
  :func:`reference_state_dict` for writing one.  A bare HF ``BertModel``
  state dict (``bert.*`` or unprefixed keys, no ``linear.weight``) loads
  too, with ``require_head=False``, as the JAX package's
  ``colbert_params_from_torch`` accepts it.

The cross-encoder's head carries a bias (``linear.bias``; the ColBERT
projection has none): pass ``head_bias=True`` to
:func:`state_dict_from_reference` and :func:`reference_state_dict` for its
reference ``pytorch.bin`` (``model.*`` + ``linear.weight`` +
``linear.bias``), the layout ``colbert_tpu/models/convert.py::
ce_params_from_torch`` reads.  :func:`state_dict_from_jax_params` carries
the bias whenever the JAX tree has one.

:func:`flax_paths` names every port parameter by its flax path, which the
optimizer's weight-decay mask reads (``training/train_state.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from colbert_tpu_torch.config import ModelConfig

# (port module path, reference module path, kind) for one BERT layer
_LAYER_MAP = (
    ("attention.query", "attention.self.query", "dense"),
    ("attention.key", "attention.self.key", "dense"),
    ("attention.value", "attention.self.value", "dense"),
    ("attention.out", "attention.output.dense", "dense"),
    ("attention_layernorm", "attention.output.LayerNorm", "ln"),
    ("intermediate", "intermediate.dense", "dense"),
    ("output", "output.dense", "dense"),
    ("output_layernorm", "output.LayerNorm", "ln"),
)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def state_dict_from_jax_params(params: Mapping[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """JAX ``{'bert': ..., 'linear': {'kernel'[, 'bias']}}`` tree -> port state dict."""
    out: Dict[str, torch.Tensor] = {}

    def dense(prefix: str, node) -> None:
        out[prefix + ".weight"] = _t(np.asarray(node["kernel"]).T)
        if "bias" in node:
            out[prefix + ".bias"] = _t(node["bias"])

    def ln(prefix: str, node) -> None:
        out[prefix + ".weight"] = _t(node["scale"])
        out[prefix + ".bias"] = _t(node["bias"])

    bert = params["bert"]
    emb = bert["embeddings"]
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        out[f"bert.embeddings.{name}.weight"] = _t(emb[name]["embedding"])
    ln("bert.embeddings.layernorm", emb["layernorm"])
    for i in range(cfg.num_layers):
        node = bert[f"layer_{i}"]
        for port, _, kind in _LAYER_MAP:
            sub = node
            for part in port.split("."):
                sub = sub[part]
            (dense if kind == "dense" else ln)(f"bert.layers.{i}.{port}", sub)
    dense("linear", params["linear"])
    return out


def flax_paths(cfg: ModelConfig) -> Dict[str, str]:
    """Port parameter name -> its flax path, ``/``-joined
    (``bert/layer_0/attention/query/kernel``, ``bert/embeddings/layernorm/scale``)."""
    out = {f"bert.embeddings.{n}.weight": f"bert/embeddings/{n}/embedding"
           for n in ("word_embeddings", "position_embeddings", "token_type_embeddings")}
    leaf = {("dense", "weight"): "kernel", ("dense", "bias"): "bias",
            ("ln", "weight"): "scale", ("ln", "bias"): "bias"}
    out["bert.embeddings.layernorm.weight"] = "bert/embeddings/layernorm/scale"
    out["bert.embeddings.layernorm.bias"] = "bert/embeddings/layernorm/bias"
    for i in range(cfg.num_layers):
        for port, _, kind in _LAYER_MAP:
            for t in ("weight", "bias"):
                out[f"bert.layers.{i}.{port}.{t}"] = f"bert/layer_{i}/{port.replace('.', '/')}/{leaf[kind, t]}"
    out["linear.weight"] = "linear/kernel"
    out["linear.bias"] = "linear/bias"  # the cross-encoder's head
    return out


def _key_pairs(cfg: ModelConfig, head_bias: bool = False):
    """(port key, reference key) for every parameter."""
    pairs = [
        (f"bert.embeddings.{n}.weight", f"model.embeddings.{n}.weight")
        for n in ("word_embeddings", "position_embeddings", "token_type_embeddings")
    ]
    pairs += [
        ("bert.embeddings.layernorm.weight", "model.embeddings.LayerNorm.weight"),
        ("bert.embeddings.layernorm.bias", "model.embeddings.LayerNorm.bias"),
    ]
    for i in range(cfg.num_layers):
        for port, ref, _ in _LAYER_MAP:
            for leaf in ("weight", "bias"):
                pairs.append(
                    (f"bert.layers.{i}.{port}.{leaf}", f"model.encoder.layer.{i}.{ref}.{leaf}")
                )
    pairs.append(("linear.weight", "linear.weight"))
    if head_bias:
        pairs.append(("linear.bias", "linear.bias"))
    return pairs


def _reference_keys(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """``bert.*`` or unprefixed HF BERT keys -> the reference's ``model.*``."""
    out = {}
    for k, v in sd.items():
        for pre in ("model.", "bert."):
            if k.startswith(pre):
                k = "model." + k[len(pre):]
                break
        if k.startswith(("embeddings.", "encoder.", "pooler.")):
            k = "model." + k
        out[k] = v
    return out


def state_dict_from_reference(path_or_sd, cfg: ModelConfig, *, require_head: bool = True,
                              head_bias: bool = False) -> Dict[str, torch.Tensor]:
    """Reference ``pytorch.bin`` (``model.*`` + ``linear.weight``, and
    ``linear.bias`` with ``head_bias``) -> port state dict.

    Both sides store torch's (out, in) layout, so only the keys change.
    With ``require_head=False`` a checkpoint without the ``linear.*`` head
    (a bare BERT) gives a state dict without it."""
    if isinstance(path_or_sd, (str, bytes)) or hasattr(path_or_sd, "__fspath__"):
        sd = torch.load(path_or_sd, map_location="cpu", weights_only=True)
    else:
        sd = path_or_sd
    sd = _reference_keys(sd)
    pairs = [(port, ref) for port, ref in _key_pairs(cfg, head_bias)
             if require_head or not ref.startswith("linear.") or "linear.weight" in sd]
    missing = [ref for _, ref in pairs if ref not in sd]
    if missing:
        raise KeyError(
            f"checkpoint lacks {len(missing)} reference keys (first: {missing[0]}); "
            "expected the layout colbert_params_to_torch_state_dict writes"
        )
    return {port: sd[ref].float() if torch.is_tensor(sd[ref]) else _t(sd[ref]) for port, ref in pairs}


def reference_state_dict(state_dict: Mapping[str, torch.Tensor], cfg: ModelConfig, *,
                         head_bias: bool = False) -> Dict[str, torch.Tensor]:
    """Port state dict -> reference ``pytorch.bin`` key layout."""
    return {ref: state_dict[port].detach().cpu().float() for port, ref in _key_pairs(cfg, head_bias)}

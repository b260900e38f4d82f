"""Tensor-parallel parameter sharding: counterpart of ``colbert_tpu/models/sharding.py``.

The JAX package shards the per-layer matmuls over the mesh's ``model`` axis
in the Megatron pattern, by parameter path (:func:`spec_for`, a copy of its
``_spec_for``):

  * attention query/key/value kernels and the MLP intermediate kernel: the
    output (head) dim;
  * attention out kernel and MLP output kernel: the input dim;
  * embeddings, LayerNorms, every bias and the heads: replicated.

The port holds the split kernels as one shard a position of the model group
(``models/bert.py``: :class:`ColumnParallel`, :class:`RowParallel`) and
every replicated parameter once, on the group's first position.  Torch
stores a dense weight (out, in), flax's kernel (in, out): JAX's output
split is a split of the port's dim 0, its input split of dim 1.  A shard's
parameter name is the full one with the position appended
(``bert.layers.0.attention.query.weight.1``).

* :func:`shard_state` / :func:`gather_state`: a full state dict (the
  layout of ``model = 1`` and of every checkpoint) to one shard a position,
  and back;
* :func:`place`: a model on one data position's model group (sharded in
  place at ``model > 1``, as ``.to`` moves a module in place);
* :class:`FullStateDict`: the models' ``state_dict`` / ``load_state_dict``
  in the full layout, sharded or not, so that checkpoints, conversions and
  copies never see a shard.

Splits fall on whole heads: a configuration whose heads (or intermediate
width) do not divide by ``model`` is refused (:func:`check_divisible`).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from colbert_tpu_torch.config import ModelConfig
from colbert_tpu_torch.models.bert import BertLayer, ColumnParallel, Dense, RowParallel
from colbert_tpu_torch.models.convert import flax_paths

MODEL_AXIS = "model"
#: the refusal's pointer (ROADMAP.md Queue 1 step 10)
UNEVEN_HEADS = "ROADMAP.md Queue 1 step 10: a model axis must split the heads and the MLP into whole, equal parts"

_SHARD = re.compile(r"^(.*)\.(\d+)$")


def spec_for(path: str, ndim: int) -> Tuple:
    """The JAX partition spec of the flax parameter at ``path`` (``/``-joined)
    with ``ndim`` dims, as a tuple: ``()`` replicated, ``(None, "model")``
    split by output columns, ``("model", None)`` split by input rows."""
    if ndim < 2:
        return ()
    if any(k in path for k in ("query/kernel", "key/kernel", "value/kernel", "intermediate/kernel")):
        return (None, MODEL_AXIS)
    if path.endswith("attention/out/kernel") or path.endswith("output/kernel"):
        return (MODEL_AXIS, None)
    return ()


def split_dim(path: str, ndim: int) -> Optional[int]:
    """The port dim a parameter (flax ``path``) is split along: 0 for JAX's
    output split, 1 for its input split (torch's (out, in) layout), None
    where it is replicated."""
    spec = spec_for(path, ndim)
    if not spec:
        return None
    return 0 if spec == (None, MODEL_AXIS) else 1


def full_name(name: str, paths: Mapping[str, str]) -> str:
    """The full parameter's name of a port parameter or shard."""
    if name in paths:
        return name
    m = _SHARD.match(name)
    if m and m.group(1) in paths:
        return m.group(1)
    raise KeyError(f"no flax path for parameter {name!r}")


def param_path(name: str, paths: Mapping[str, str]) -> str:
    """The flax path of a port parameter or of one of its shards."""
    return paths[full_name(name, paths)]


def check_divisible(cfg: ModelConfig, model: int) -> None:
    """Refuse a model axis that does not split the heads and the MLP whole."""
    if model <= 1:
        return
    if cfg.num_heads % model or cfg.intermediate_size % model:
        raise NotImplementedError(
            f"mesh.model={model} with {cfg.num_heads} heads, hidden {cfg.hidden_size} and intermediate "
            f"{cfg.intermediate_size}: {UNEVEN_HEADS}")


def shard_state(state: Mapping[str, torch.Tensor], cfg: ModelConfig, model: int) -> Dict[str, torch.Tensor]:
    """A full state dict as ``model`` shards of each split parameter
    (``name.p``, position p's part) and every other parameter once."""
    check_divisible(cfg, model)
    if model == 1:
        return dict(state)
    paths = flax_paths(cfg)
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        dim = split_dim(paths[name], t.dim())
        if dim is None:
            out[name] = t
            continue
        for p, part in enumerate(t.chunk(model, dim)):
            out[f"{name}.{p}"] = part
    return out


def gather_state(state: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """The full state dict of a sharded one (:func:`shard_state`'s inverse),
    on the CPU; a full one is returned as it is."""
    paths = flax_paths(cfg)
    shards: Dict[str, Dict[int, torch.Tensor]] = {}
    out: Dict[str, torch.Tensor] = {}
    for name, t in state.items():
        full = full_name(name, paths)
        if full == name:
            out[name] = t
        else:
            shards.setdefault(full, {})[int(name[len(full) + 1 :])] = t
    for full, parts in shards.items():
        ordered = [parts[p].detach().cpu() for p in range(len(parts))]
        out[full] = torch.cat(ordered, dim=split_dim(paths[full], ordered[0].dim()))
    # the order of a model = 1 state dict
    order = {n: i for i, n in enumerate(paths)}
    return {k: out[k] for k in sorted(out, key=lambda n: order[n])}


def model_group(model: nn.Module) -> Optional[Tuple[torch.device, ...]]:
    """The model group a model is sharded over (None: not sharded)."""
    return getattr(model, "model_group", None)


def shard_model(model: nn.Module, group: Sequence[torch.device]) -> nn.Module:
    """Shard ``model`` (a ``ColbertModel`` or ``CrossEncoderModel`` holding
    full parameters) in place over ``group``: every BERT layer's split
    projections as :class:`ColumnParallel` / :class:`RowParallel`, everything
    else on ``group[0]``."""
    group = tuple(torch.device(d) for d in group)
    check_divisible(model.cfg, len(group))
    model.to(group[0])
    for layer in [m for m in model.modules() if isinstance(m, BertLayer)]:
        att = layer.attention
        att.query, att.key, att.value = (ColumnParallel(d, group) for d in (att.query, att.key, att.value))
        att.out = RowParallel(att.out, group)
        layer.intermediate = ColumnParallel(layer.intermediate, group)
        layer.output = RowParallel(layer.output, group)
    model.model_group = group
    return model


def _dense(layer: nn.Module) -> Dense:
    """The :class:`Dense` a parallel layer splits, on its first position."""
    home = layer.group[0]
    w = torch.cat([t.detach().to(home) for t in layer.weight], dim=0 if isinstance(layer, ColumnParallel) else 1)
    with torch.device("meta"):
        dense = Dense(w.shape[1], w.shape[0])
    dense.weight = nn.Parameter(w)
    dense.bias = nn.Parameter(layer.bias.detach().clone())
    return dense


def unshard_model(model: nn.Module) -> nn.Module:
    """:func:`shard_model`'s inverse, in place: full parameters on the first position."""
    for layer in [m for m in model.modules() if isinstance(m, BertLayer)]:
        att = layer.attention
        att.query, att.key, att.value, att.out = (_dense(d) for d in (att.query, att.key, att.value, att.out))
        layer.intermediate, layer.output = _dense(layer.intermediate), _dense(layer.output)
    del model.model_group
    return model


def place(model: nn.Module, group: Sequence[torch.device]) -> nn.Module:
    """``model`` on one data position's model ``group`` (its devices, one a
    position): ``model.to(group[0])`` for one position, else sharded over
    them.  A model sharded over another group is gathered first."""
    group = tuple(torch.device(d) for d in group)
    current = model_group(model)
    if current == group:
        return model
    if current is not None:
        unshard_model(model)  # full parameters on the old group's first device
    if len(group) == 1:
        return model.to(group[0])
    return shard_model(model, group)


class FullStateDict:
    """``nn.Module`` mixin of the models (``cfg`` their ``ModelConfig``):
    ``state_dict()`` gives, and ``load_state_dict`` takes, the full (``model
    = 1``) layout whether or not the model is sharded."""

    def state_dict(self, *args, **kwargs):
        sd = super().state_dict(*args, **kwargs)
        nested = args or kwargs.get("destination") is not None or kwargs.get("prefix")
        return gather_state(sd, self.cfg) if model_group(self) and not nested else sd

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        group = model_group(self)
        if group:
            state_dict = shard_state(state_dict, self.cfg, len(group))
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

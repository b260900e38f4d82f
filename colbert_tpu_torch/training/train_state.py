"""Optimizer: counterpart of the optax chain of ``colbert_tpu/training/train_state.py:26-62``.

* global-norm clipping at ``max_grad_norm`` (optax's ``clip_by_global_norm``:
  unchanged below the limit, else scaled to it);
* AdamW with optax's update rule, which ``torch.optim.AdamW`` computes
  (decay applied with the pre-step weights, eps added after the square
  root; ``tests/test_torch_training.py`` holds the two equal);
* weight decay masked off every parameter whose *flax* path contains
  ``bias``, ``layernorm`` or ``scale`` (``_no_decay``), the path taken from
  ``models/convert.py::flax_paths``;
* the linear warmup -> decay schedule, evaluated at the step count before
  the update, as optax's ``scale_by_schedule`` does.

A tensor-parallel model (``models/sharding.py``) gives AdamW its shards and
its replicated parameters, each held once: AdamW is elementwise, so a
shard's update is that of its slice of the full parameter.  The global
norm counts each element once (the shards' norms on their devices, summed
on the first parameter's), the decay mask goes by each shard's flax path,
and :meth:`Optimizer.state_dict` gathers the moments into the full
parameters' layout, so that a checkpoint's optimizer state is the same at
every ``mesh.model``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from colbert_tpu_torch.config import ModelConfig, TrainConfig
from colbert_tpu_torch.models.convert import flax_paths
from colbert_tpu_torch.models.sharding import full_name, model_group, param_path, split_dim


_MOMENTS = ("exp_avg", "exp_avg_sq")  # AdamW's per-element state, split as its parameter is


def no_decay(path: str) -> bool:
    p = path.lower()
    return "bias" in p or "layernorm" in p or "scale" in p


def lr_schedule(cfg: TrainConfig, total_steps: int) -> Callable[[int], float]:
    """optax ``join_schedules`` of two linear schedules, boundary at the warmup."""
    warmup = int(cfg.warmup_ratio * total_steps)
    up, down = max(1, warmup), max(1, total_steps - warmup)
    lr = cfg.learning_rate

    def at(count: int) -> float:
        if count < warmup:
            return lr * min(max(count, 0), up) / up
        return lr * (1.0 - min(max(count - warmup, 0), down) / down)

    return at


class Optimizer:
    """Clip + AdamW + schedule over a model's parameters; ``count`` is the
    number of updates applied (optax's step count)."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, model_cfg: ModelConfig, total_steps: int):
        paths = self._paths = flax_paths(model_cfg)
        named = list(model.named_parameters())
        decay = [(n, p) for n, p in named if not no_decay(param_path(n, paths))]
        rest = [(n, p) for n, p in named if no_decay(param_path(n, paths))]
        self.sharded = model_group(model) is not None
        self._names = [n for n, _ in decay + rest]  # AdamW's parameter order
        self.params: List[torch.nn.Parameter] = [p for _, p in named]
        self.max_grad_norm = cfg.max_grad_norm
        self.schedule = lr_schedule(cfg, total_steps)
        self.count = 0
        self.adamw = torch.optim.AdamW(
            [{"params": [p for _, p in decay], "weight_decay": cfg.weight_decay},
             {"params": [p for _, p in rest], "weight_decay": 0.0}],
            lr=self.schedule(0), betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
        )

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def clip_grads(self) -> None:
        """Scale the gradients to global norm ``max_grad_norm`` if above it
        (no host sync); the gradients of each device scaled there."""
        by_device: Dict[torch.device, List[torch.Tensor]] = {}
        for p in self.params:
            by_device.setdefault(p.grad.device, []).append(p.grad)
        home = self.params[0].grad.device
        norms = [torch.stack(torch._foreach_norm(gs)).to(home) for gs in by_device.values()]
        norm = torch.linalg.vector_norm(norms[0] if len(norms) == 1 else torch.cat(norms))
        coef = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
        for dev, gs in by_device.items():
            torch._foreach_mul_(gs, coef.to(dev))

    def step(self) -> None:
        """One update from the gradients in ``.grad`` (every parameter has one
        after a train step's backward): clip, then AdamW at the learning rate
        of the current count."""
        self.clip_grads()
        for g in self.adamw.param_groups:
            g["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1

    def state_dict(self) -> Dict[str, Any]:
        """AdamW's state dict and the count; a sharded model's moments
        gathered into the full parameters (the ``model = 1`` layout)."""
        sd = self.adamw.state_dict()
        if self.sharded:
            sd = self._full_layout(sd)
        return {"adamw": sd, "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        sd = state["adamw"]
        if self.sharded:
            sd = self._shard_layout(sd)
        self.adamw.load_state_dict(sd)
        self.count = int(state["count"])

    def _full_names(self) -> List[str]:
        """The full parameters in AdamW's order (a full parameter where its first shard is)."""
        return list(dict.fromkeys(full_name(n, self._paths) for n in self._names))

    def _full_layout(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        full = self._full_names()
        index = {n: i for i, n in enumerate(full)}
        state: Dict[int, Dict[str, Any]] = {}
        shards: Dict[str, List[Dict[str, Any]]] = {}
        for i, n in enumerate(self._names):
            if i in sd["state"]:
                shards.setdefault(full_name(n, self._paths), []).append(sd["state"][i])
        for f, parts in shards.items():
            dim = split_dim(self._paths[f], parts[0]["exp_avg"].dim())
            entry = dict(parts[0])
            for key in _MOMENTS:
                ts = [part[key].detach().cpu() for part in parts]
                entry[key] = ts[0] if dim is None else torch.cat(ts, dim=dim)
            state[index[f]] = entry
        groups = []
        for g in sd["param_groups"]:
            names = dict.fromkeys(full_name(self._names[i], self._paths) for i in g["params"])
            groups.append({**g, "params": [index[n] for n in names]})
        return {"state": state, "param_groups": groups}

    def _shard_layout(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        full = self._full_names()
        params = {n: p for n, p in zip(self._names, [p for g in self.adamw.param_groups for p in g["params"]])}
        state: Dict[int, Dict[str, Any]] = {}
        for i, n in enumerate(self._names):
            f = full_name(n, self._paths)
            entry = sd["state"].get(full.index(f))
            if entry is None:
                continue
            # each shard its own step tensor: AdamW would count a shared one once a shard
            entry = {k: v.clone() if torch.is_tensor(v) and k not in _MOMENTS else v for k, v in entry.items()}
            if f != n:
                dim = split_dim(self._paths[f], entry["exp_avg"].dim())
                p = int(n[len(f) + 1 :])
                per = params[n].shape[dim]
                for key in _MOMENTS:
                    entry[key] = entry[key].narrow(dim, p * per, per).clone(memory_format=torch.contiguous_format)
            state[i] = entry
        groups, start = [], 0
        for g, live in zip(sd["param_groups"], self.adamw.param_groups):
            groups.append({**g, "params": list(range(start, start + len(live["params"])))})
            start += len(live["params"])
        return {"state": state, "param_groups": groups}

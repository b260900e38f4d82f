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
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from colbert_tpu_torch.config import ModelConfig, TrainConfig
from colbert_tpu_torch.models.convert import flax_paths


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
        paths = flax_paths(model_cfg)
        named = list(model.named_parameters())
        decay = [p for n, p in named if not no_decay(paths[n])]
        rest = [p for n, p in named if no_decay(paths[n])]
        self.params: List[torch.nn.Parameter] = [p for _, p in named]
        self.max_grad_norm = cfg.max_grad_norm
        self.schedule = lr_schedule(cfg, total_steps)
        self.count = 0
        self.adamw = torch.optim.AdamW(
            [{"params": decay, "weight_decay": cfg.weight_decay}, {"params": rest, "weight_decay": 0.0}],
            lr=self.schedule(0), betas=(cfg.adam_b1, cfg.adam_b2), eps=cfg.adam_eps,
        )

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def clip_grads(self) -> None:
        """Scale the gradients to global norm ``max_grad_norm`` if above it (no host sync)."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        coef = torch.where(norm < self.max_grad_norm, torch.ones_like(norm), self.max_grad_norm / norm)
        torch._foreach_mul_(grads, coef)

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
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.adamw.load_state_dict(state["adamw"])
        self.count = int(state["count"])

"""ColBERT bi-encoder: BERT + bias-free projection + L2 normalisation (+multiview).

Counterpart of ``colbert_tpu/models/colbert.py``: optionally keep the first
``q_view``/``d_view`` positions (multiview), project with a bias-free
``Linear(hidden, dim)`` in the compute dtype, cast to fp32 and divide by
``max(norm, 1e-12)``.  In ``train()`` mode the encoder's dropout sites draw
their seeds from the ``generator`` passed to :meth:`query` / :meth:`doc`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from colbert_tpu_torch.config import ModelConfig, MultiviewConfig
from colbert_tpu_torch.models.bert import BertEncoder, Dense
from colbert_tpu_torch.models.sharding import FullStateDict


class ColbertModel(FullStateDict, nn.Module):
    def __init__(self, cfg: ModelConfig, multiview: MultiviewConfig):
        super().__init__()
        self.cfg = cfg
        self.multiview = multiview
        self.bert = BertEncoder(cfg)
        self.linear = Dense(cfg.hidden_size, cfg.dim, bias=False)

    def _represent(self, hidden: torch.Tensor, is_query: bool) -> torch.Tensor:
        if self.multiview.enabled:
            view = self.multiview.q_view if is_query else self.multiview.d_view
            hidden = hidden[:, :view, :]
        t = self.linear(hidden).float()
        norm = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        return t / norm.clamp_min(1e-12)

    def query(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._represent(self.bert(input_ids, attention_mask, generator=generator), is_query=True)

    def doc(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._represent(self.bert(input_ids, attention_mask, generator=generator), is_query=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random init with flax's initializers (see ``BertEncoder.init_weights``)."""
        self.bert.init_weights(generator)
        self.linear.weight.normal_(0.0, self.cfg.initializer_range, generator=generator)

"""Cross-encoder reranker: BERT + a biased ``Linear(hidden, 1)`` over position 0.

Counterpart of ``colbert_tpu/models/ce.py:17-32`` (reference ``CEModel``,
``colbert/modeling/ce_model.py:41-101``): the logit is a biased linear
readout of the last hidden state at position 0 ([CLS]), computed in the
model dtype (bf16 at the reference point, as flax's ``nn.Dense(dtype=...)``
computes it) and only then cast to fp32.  In ``train()`` mode the
encoder's dropout sites draw their seeds from the ``generator`` passed to
:meth:`forward` (kernel K9 for the "byte"/"hw" impls).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from colbert_tpu_torch.config import ModelConfig
from colbert_tpu_torch.models.bert import BertEncoder, Dense
from colbert_tpu_torch.models.sharding import FullStateDict


class CrossEncoderModel(FullStateDict, nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.bert = BertEncoder(cfg)
        self.linear = Dense(cfg.hidden_size, 1)

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """One fp32 logit per (question, passage) row, shape (B,)."""
        hidden = self.bert(input_ids, attention_mask, generator=generator)
        return self.linear(hidden[:, 0, :]).float()[:, 0]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random init with flax's initializers: normal(initializer_range)
        readout kernel, zero bias (see ``BertEncoder.init_weights``)."""
        self.bert.init_weights(generator)
        self.linear.weight.normal_(0.0, self.cfg.initializer_range, generator=generator)
        self.linear.bias.zero_()

"""BERT encoder for inference, in PyTorch.

Counterpart of ``colbert_tpu/models/bert.py`` with the same numerics:

* parameters are fp32; compute runs in ``cfg.dtype`` (weights are cast at
  use, as flax's ``dtype=`` does);
* attention logits and softmax are fp32 (``attention_softmax_dtype="fp32"``,
  the reference default), the additive mask bias is ``-1e9``;
* GELU is exact (erf);
* LayerNorm follows flax: statistics in fp32 with the fast variance
  ``E[x^2] - E[x]^2`` clipped at 0, output in the compute dtype.

Attention is written as explicit matmuls and a softmax: the JAX package
leaves it to XLA (no Pallas kernel of its own), and the explicit form is
what the parity tests pin.  There are no dropout modules: training is a
later slice.  Module names follow the flax parameter tree so conversion is
mechanical (``models/convert.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from colbert_tpu.config import ModelConfig


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[cfg.dtype]


class Dense(nn.Linear):
    """``nn.Linear`` whose fp32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` semantics: fp32 statistics, output in ``dtype``."""

    def __init__(self, features: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids, dtype: torch.dtype) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (
            F.embedding(input_ids, self.word_embeddings.weight.to(dtype))
            + F.embedding(positions, self.position_embeddings.weight.to(dtype))
            + F.embedding(token_type_ids, self.token_type_embeddings.weight.to(dtype))
        )
        return self.layernorm(x, dtype)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.query = Dense(h, h)
        self.key = Dense(h, h)
        self.value = Dense(h, h)
        self.out = Dense(h, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        B, L, h = x.shape
        nh = self.num_heads
        hd = h // nh
        split = lambda t: t.view(B, L, nh, hd).transpose(1, 2)      # (B, nh, L, hd)
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        # fp32 logits from compute-dtype q/k (XLA's preferred_element_type=f32)
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        logits = logits / math.sqrt(hd) + bias
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, h)
        return self.out(ctx)


class BertLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.attention = BertSelfAttention(cfg)
        self.attention_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size)
        self.output_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
        x = self.attention_layernorm(x + self.attention(x, bias), x.dtype)
        y = self.output(F.gelu(self.intermediate(x)))
        return self.output_layernorm(x + y, x.dtype)


class BertEncoder(nn.Module):
    """Returns the last layer's hidden states, shape (B, L, H), in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        dtype = compute_dtype(self.cfg)
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids.long(), dtype)
        # additive mask bias, fp32: 0 for attend, -1e9 for masked
        bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for layer in self.layers:
            x = layer(x, bias)
        return x

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's init: normal(initializer_range) kernels and embeddings,
        zero biases, unit LayerNorm scales."""
        std = self.cfg.initializer_range
        for mod in self.modules():
            if isinstance(mod, (nn.Linear, nn.Embedding)):
                mod.weight.normal_(0.0, std, generator=generator)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

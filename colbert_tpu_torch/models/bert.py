"""BERT encoder in PyTorch, for inference and training.

Counterpart of ``colbert_tpu/models/bert.py`` with the same numerics:

* parameters are fp32; compute runs in ``cfg.dtype`` (weights are cast at
  use, as flax's ``dtype=`` does);
* attention logits and softmax are fp32 (``attention_softmax_dtype="fp32"``,
  the reference default) or in the compute dtype (``"compute"``); the
  additive mask bias is ``-1e9``;
* GELU is exact (erf);
* LayerNorm follows flax: statistics in fp32 with the fast variance
  ``E[x^2] - E[x]^2`` clipped at 0, output in the compute dtype;
* dropout at the embeddings, the attention probabilities (or the attention
  output, per ``attention_dropout_site``), the attention block output and
  the FFN output, active in ``train()`` mode (flax's ``deterministic=False``).
  ``dropout_impl`` "byte" and "hw" run the byte-threshold kernel K9
  (``ops/dropout.py``); "exact" is ``F.dropout``.  Each site draws its seed
  from the ``generator`` the caller passes for the pass.

Attention is written as explicit matmuls and a softmax: the JAX package
leaves it to XLA (no Pallas kernel of its own), and the explicit form is
what the parity tests pin.  ``attention_impl="flash"`` and ``remat`` other
than "none" are not ported and raise.  Module names follow the flax
parameter tree so conversion is mechanical (``models/convert.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from colbert_tpu_torch.config import ModelConfig
from colbert_tpu_torch.ops.dropout import hw_dropout, threshold


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[cfg.dtype]


def check_ported(cfg: ModelConfig) -> None:
    """Refuse the model options the port does not compute (never a silent fallback)."""
    if cfg.attention_impl == "flash":
        raise NotImplementedError(
            "model.attention_impl='flash' is not ported to colbert_tpu_torch "
            "(ROADMAP.md Queue 1 step 12); use 'auto' or 'xla'"
        )
    if cfg.remat != "none":
        raise NotImplementedError(
            f"model.remat={cfg.remat!r} is not ported to colbert_tpu_torch "
            "(ROADMAP.md Queue 1 step 12); use 'none'"
        )


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """One 62-bit dropout seed from ``generator`` (torch's default CPU generator if None)."""
    return int(torch.randint(0, 1 << 62, (1,), generator=generator).item())


class Dropout(nn.Module):
    """Dropout at one site; the identity in ``eval()`` mode or at rate 0.

    "byte"/"hw": drop probability ``round(rate * 256) / 256`` by the K9
    kernel, its mask regenerated in the backward pass.  "exact": ``F.dropout``
    at ``rate``, seeded per call so a step's stream is reproducible."""

    def __init__(self, rate: float, impl: str):
        super().__init__()
        self.rate = rate
        self.impl = impl

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        if self.impl == "exact":
            devices = [x.device] if x.device.type == "cuda" else []
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed(draw_seed(generator))
                return F.dropout(x, self.rate, training=True)
        thr = threshold(self.rate)
        if thr <= 0:
            return x
        return hw_dropout(x, draw_seed(generator), thr)


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
        self.dropout = Dropout(cfg.hidden_dropout, cfg.dropout_impl)

    def forward(self, input_ids, token_type_ids, dtype: torch.dtype, generator=None) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        x = (
            F.embedding(input_ids, self.word_embeddings.weight.to(dtype))
            + F.embedding(positions, self.position_embeddings.weight.to(dtype))
            + F.embedding(token_type_ids, self.token_type_embeddings.weight.to(dtype))
        )
        return self.dropout(self.layernorm(x, dtype), generator)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.softmax_fp32 = cfg.attention_softmax_dtype == "fp32"
        self.dropout_site = cfg.attention_dropout_site
        self.dropout = Dropout(cfg.attention_dropout, cfg.dropout_impl)
        self.query = Dense(h, h)
        self.key = Dense(h, h)
        self.value = Dense(h, h)
        self.out = Dense(h, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, generator=None) -> torch.Tensor:
        B, L, h = x.shape
        nh = self.num_heads
        hd = h // nh
        split = lambda t: t.view(B, L, nh, hd).transpose(1, 2)      # (B, nh, L, hd)
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        if self.softmax_fp32:
            # fp32 logits from compute-dtype q/k (XLA's preferred_element_type=f32)
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
            logits = logits / math.sqrt(hd) + bias
        else:
            # "compute": logits, scale, bias and softmax in the compute dtype
            sm = x.dtype
            logits = torch.matmul(q, k.transpose(-1, -2))
            logits = logits / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(sm) + bias.to(sm)
        if self.softmax_fp32:
            probs = torch.softmax(logits, dim=-1).to(x.dtype)
        else:
            # jax.nn.softmax's steps, each rounded to the compute dtype
            # (torch.softmax would round only its output)
            e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
            probs = e / e.sum(dim=-1, keepdim=True)
        if self.dropout_site == "probs":
            probs = self.dropout(probs, generator)
        ctx = torch.matmul(probs, v).transpose(1, 2).reshape(B, L, h)
        if self.dropout_site == "output":
            ctx = self.dropout(ctx, generator)
        return self.out(ctx)


class BertLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.attention = BertSelfAttention(cfg)
        self.attention_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size)
        self.output_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.attention_dropout = Dropout(cfg.hidden_dropout, cfg.dropout_impl)
        self.output_dropout = Dropout(cfg.hidden_dropout, cfg.dropout_impl)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, generator=None) -> torch.Tensor:
        attn = self.attention_dropout(self.attention(x, bias, generator), generator)
        x = self.attention_layernorm(x + attn, x.dtype)
        y = self.output_dropout(self.output(F.gelu(self.intermediate(x))), generator)
        return self.output_layernorm(x + y, x.dtype)


class BertEncoder(nn.Module):
    """Returns the last layer's hidden states, shape (B, L, H), in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        check_ported(cfg)
        self.cfg = cfg
        self.embeddings = BertEmbeddings(cfg)
        self.layers = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``generator`` seeds the pass's dropout sites in ``train()`` mode."""
        dtype = compute_dtype(self.cfg)
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids.long(), dtype, generator)
        # additive mask bias, fp32: 0 for attend, -1e9 for masked
        bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for layer in self.layers:
            x = layer(x, bias, generator)
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

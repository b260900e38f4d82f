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
  from the ``generator`` the caller passes for the pass, a layer's seeds
  before the layer runs (so a recomputed layer drops the same elements).

Attention, as the JAX package dispatches it (``colbert_tpu/models/bert.py:
122-135``): ``attention_impl="flash"`` at a sequence length that is a
multiple of 128 (docs and CE pairs at 384) runs the flash-attention
kernels K11-K13 (``ops/flash_attention.py``, the port of the Pallas TPU
kernels JAX's ``flash_attention`` reaches): segment-equality mask from the
attention mask, no (B, h, L, L) tensor, and the attention dropout on the
attention output, whatever ``attention_dropout_site`` says; every other
site (queries at 32, "auto", "xla") is explicit matmuls and a softmax, as
XLA computes it there.  ``remat`` wraps each layer in non-reentrant
``torch.utils.checkpoint``: "full" saves nothing, "dots" only matmul
outputs, "attn" everything but the explicit path's logits and
probabilities.  Module names follow the flax parameter tree so conversion
is mechanical (``models/convert.py``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
                                    noop_context_fn)

from colbert_tpu_torch.config import ModelConfig
from colbert_tpu_torch.ops.dropout import hw_dropout, threshold
from colbert_tpu_torch.ops.flash_attention import flash_attention


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[cfg.dtype]


def use_flash(cfg: ModelConfig, seq_len: int) -> bool:
    """The JAX package's dispatch (``colbert_tpu/models/bert.py:122-135``):
    flash only when asked for, at a length that is a multiple of 128."""
    return cfg.attention_impl == "flash" and seq_len % 128 == 0 and seq_len >= 128


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """One 62-bit dropout seed from ``generator`` (torch's default CPU generator if None)."""
    return int(torch.randint(0, 1 << 62, (1,), generator=generator).item())


class Dropout(nn.Module):
    """Dropout at one site; the identity in ``eval()`` mode or at rate 0.

    "byte"/"hw": drop probability ``round(rate * 256) / 256`` by the K9
    kernel, its mask regenerated in the backward pass.  "exact": ``F.dropout``
    at ``rate``, seeded per call so a step's stream is reproducible.  A call
    takes the seed :meth:`seed` drew (None: the identity)."""

    def __init__(self, rate: float, impl: str):
        super().__init__()
        self.rate = rate
        self.impl = impl

    def seed(self, generator: Optional[torch.Generator]) -> Optional[int]:
        """This site's seed for one pass, or None where the site is the identity."""
        if not self.training or self.rate <= 0.0:
            return None
        if self.impl != "exact" and threshold(self.rate) <= 0:
            return None
        return draw_seed(generator)

    def forward(self, x: torch.Tensor, seed: Optional[int]) -> torch.Tensor:
        if seed is None:
            return x
        if self.impl == "exact":
            devices = [x.device] if x.device.type == "cuda" else []
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed(seed)
                return F.dropout(x, self.rate, training=True)
        return hw_dropout(x, seed, threshold(self.rate))


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


ONE_HOT_ROWS = 16  # tables up to this many rows (token types) take their gradient as a one-hot product
RUN_ROWS = 128     # rows a first-level segment of the sorted sum adds serially


def one_hot_sum(ids: torch.Tensor, grad: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, H) fp32: the rows of ``grad`` (N, H) summed by id (``ids`` (N,)),
    as the product ``one_hot(ids, rows)^T @ grad`` in fp32.  The one-hot factor
    is exact, so each sum is the GEMM's fp32 sum, in the fixed order a
    matrix product on the card takes every run."""
    return F.one_hot(ids, rows).float().t() @ grad.float()


def sorted_sum(ids: torch.Tensor, grad: torch.Tensor, rows: int) -> torch.Tensor:
    """(rows, H) fp32: the rows of ``grad`` (N, H) summed by id (``ids`` (N,)),
    in one fixed order and with no atomics.  The ids are sorted stably and
    the sorted rows cut where an id starts and at every :data:`RUN_ROWS`-th
    row; each piece (one id, at most ``RUN_ROWS`` rows) is summed serially in
    fp32, then each id's pieces serially (``torch.segment_reduce``), so no
    serial sum is longer than ``RUN_ROWS`` + N / ``RUN_ROWS`` + 1.  Every
    shape is fixed by N and ``rows`` (no host sync): an id the batch lacks
    starts at N, so its cut sorts past the at most min(rows, N) + N /
    ``RUN_ROWS`` cuts that start pieces and is dropped, and it gets an empty
    sum."""
    n, d = ids.numel(), ids.device
    sorted_ids, order = torch.sort(ids.int(), stable=True)  # 32-bit keys: half the radix passes of 64
    first = torch.searchsorted(sorted_ids, torch.arange(rows + 1, dtype=torch.int32, device=d), out_int32=True)
    starts = first[:-1].masked_fill(first[1:] == first[:-1], n)
    cuts = torch.cat([starts, torch.arange(0, n, RUN_ROWS, dtype=torch.int32, device=d)]).sort().values
    cuts = cuts[:min(rows, n) + -(-n // RUN_ROWS)]
    partial = torch.segment_reduce(grad.index_select(0, order).float(), "sum",
                                   lengths=torch.diff(cuts, append=first[-1:]), unsafe=True)
    return torch.segment_reduce(partial, "sum", lengths=torch.searchsorted(cuts, first).diff(), unsafe=True)


def lookup_backward(ids: torch.Tensor, grad: torch.Tensor, rows: int) -> torch.Tensor:
    """The (rows, H) gradient of ``F.embedding(ids, weight)`` for the output's
    gradient ``grad``, in ``grad``'s dtype, the same bits every run: the sum
    of each id's rows in fp32, rounded once (as ``F.embedding``'s backward
    rounds it), by :func:`one_hot_sum` for tables of at most
    :data:`ONE_HOT_ROWS` rows, else :func:`sorted_sum`."""
    ids, grad = ids.reshape(-1), grad.reshape(-1, grad.shape[-1])
    total = one_hot_sum(ids, grad, rows) if rows <= ONE_HOT_ROWS else sorted_sum(ids, grad, rows)
    return total.to(grad.dtype)


class _Lookup(torch.autograd.Function):
    """``F.embedding(ids, weight)`` whose backward on the card is
    :func:`lookup_backward`: there the lookup's own backward sums the rows of
    an id that a batch repeats in an order that varies from run to run when
    the batch has few distinct ids (a token type, a small vocabulary), so two
    steps on the same inputs could give two gradients.  On CPU tensors the
    lookup's own backward, whose order is fixed."""

    @staticmethod
    def forward(ctx, ids, weight):
        ctx.save_for_backward(ids)
        ctx.rows = weight.shape[0]
        return F.embedding(ids, weight)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        if not grad.is_cuda:
            return None, torch.ops.aten.embedding_dense_backward(grad, ids, ctx.rows, -1, False)
        return None, lookup_backward(ids, grad, ctx.rows)


def lookup(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``F.embedding(ids, weight)`` with a backward that gives the same bits every run."""
    return _Lookup.apply(ids, weight)


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
            lookup(input_ids, self.word_embeddings.weight.to(dtype))
            + F.embedding(positions, self.position_embeddings.weight.to(dtype))  # each row once: no repeats to sum
            + lookup(token_type_ids, self.token_type_embeddings.weight.to(dtype))
        )
        return self.dropout(self.layernorm(x, dtype), self.dropout.seed(generator))


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        h = cfg.hidden_size
        self.cfg = cfg
        self.num_heads = cfg.num_heads
        self.softmax_fp32 = cfg.attention_softmax_dtype == "fp32"
        self.dropout_site = cfg.attention_dropout_site
        self.dropout = Dropout(cfg.attention_dropout, cfg.dropout_impl)
        self.query = Dense(h, h)
        self.key = Dense(h, h)
        self.value = Dense(h, h)
        self.out = Dense(h, h)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, seg: Optional[torch.Tensor] = None,
                seed: Optional[int] = None) -> torch.Tensor:
        """``bias`` (B, 1, 1, L) fp32 drives the explicit path, ``seg`` (B, L)
        int32 (the attention mask) the flash path; ``seed`` is the attention
        dropout's (:meth:`Dropout.seed`)."""
        B, L, h = x.shape
        nh = self.num_heads
        hd = h // nh
        split = lambda t: t.view(B, L, nh, hd).transpose(1, 2)      # (B, nh, L, hd)
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        if use_flash(self.cfg, L):
            # the kernel has no probabilities to drop: the JAX package drops
            # the attention output at the same rate
            ctx = flash_attention(q, k, v, seg, seg, 1.0 / math.sqrt(hd)).transpose(1, 2).reshape(B, L, h)
            return self.out(self.dropout(ctx, seed))
        if self.cfg.remat == "attn" and torch.is_grad_enabled():
            # the (B, nh, L, L) logits and probabilities are recomputed in the backward pass
            ctx = checkpoint(self._explicit, q, k, v, bias, seed, use_reentrant=False, preserve_rng_state=False)
        else:
            ctx = self._explicit(q, k, v, bias, seed)
        ctx = ctx.transpose(1, 2).reshape(B, L, h)
        if self.dropout_site == "output":
            ctx = self.dropout(ctx, seed)
        return self.out(ctx)

    def _explicit(self, q, k, v, bias: torch.Tensor, seed: Optional[int]) -> torch.Tensor:
        """softmax(q k^T / sqrt(hd) + bias) v, (B, nh, L, hd), and the probabilities' dropout."""
        hd = q.shape[-1]
        if self.softmax_fp32:
            # fp32 logits from compute-dtype q/k (XLA's preferred_element_type=f32)
            logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
            logits = logits / math.sqrt(hd) + bias
            probs = torch.softmax(logits, dim=-1).to(q.dtype)
        else:
            # "compute": logits, scale, bias and softmax in the compute dtype,
            # jax.nn.softmax's steps each rounded to it (torch.softmax would
            # round only its output)
            sm = q.dtype
            logits = torch.matmul(q, k.transpose(-1, -2))
            logits = logits / torch.tensor(math.sqrt(hd), dtype=torch.float32).to(sm) + bias.to(sm)
            e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
            probs = e / e.sum(dim=-1, keepdim=True)
        if self.dropout_site == "probs":
            probs = self.dropout(probs, seed)
        return torch.matmul(probs, v)


_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default, torch.ops.aten.bmm.default,
            torch.ops.aten.baddbmm.default}


def _save_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """remat="dots": keep matmul outputs (JAX's ``checkpoint_dots``), recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


class BertLayer(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.remat = cfg.remat
        self.attention = BertSelfAttention(cfg)
        self.attention_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.intermediate = Dense(cfg.hidden_size, cfg.intermediate_size)
        self.output = Dense(cfg.intermediate_size, cfg.hidden_size)
        self.output_layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.attention_dropout = Dropout(cfg.hidden_dropout, cfg.dropout_impl)
        self.output_dropout = Dropout(cfg.hidden_dropout, cfg.dropout_impl)

    def forward(self, x: torch.Tensor, bias: torch.Tensor, seg: torch.Tensor, generator=None) -> torch.Tensor:
        # the layer's seeds, in the order its sites run, drawn before it runs:
        # a checkpointed layer's recompute takes the same ones
        seeds = (self.attention.dropout.seed(generator), self.attention_dropout.seed(generator),
                 self.output_dropout.seed(generator))
        if self.remat in ("full", "dots") and torch.is_grad_enabled():
            context_fn = (functools.partial(create_selective_checkpoint_contexts, _save_matmuls)
                          if self.remat == "dots" else noop_context_fn)
            return checkpoint(self._layer, x, bias, seg, seeds, use_reentrant=False, preserve_rng_state=False,
                              context_fn=context_fn)
        return self._layer(x, bias, seg, seeds)

    def _layer(self, x: torch.Tensor, bias: torch.Tensor, seg: torch.Tensor,
               seeds: Tuple[Optional[int], Optional[int], Optional[int]]) -> torch.Tensor:
        attn = self.attention_dropout(self.attention(x, bias, seg, seeds[0]), seeds[1])
        x = self.attention_layernorm(x + attn, x.dtype)
        y = self.output_dropout(self.output(F.gelu(self.intermediate(x))), seeds[2])
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
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """``generator`` seeds the pass's dropout sites in ``train()`` mode."""
        dtype = compute_dtype(self.cfg)
        input_ids = input_ids.long()
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids.long(), dtype, generator)
        # additive mask bias, fp32: 0 for attend, -1e9 for masked (the explicit
        # path); the mask as int32 segment ids (the flash path)
        bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        seg = attention_mask.to(torch.int32)
        for layer in self.layers:
            x = layer(x, bias, seg, generator)
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

"""BERT encoder in PyTorch, for inference and training.

Counterpart of ``colbert_tpu/models/bert.py`` with the same numerics:

* parameters are fp32; compute runs in ``cfg.dtype`` (weights are cast at
  use, as flax's ``dtype=`` does);
* attention logits and softmax are fp32 (``attention_softmax_dtype="fp32"``,
  the reference default) or in the compute dtype (``"compute"``); the
  additive mask bias is ``-1e9``;
* GELU is exact (erf);
* ``fused_qkv`` runs q, k and v as one (H, 3H) product of the three
  projections' weights concatenated at call time (the parameters and the
  state dict stay as they are); ``embedding_impl="onehot"`` takes the word
  lookup as a one-hot product, forward and backward;
* LayerNorm follows flax: statistics in fp32 with the fast variance
  ``E[x^2] - E[x]^2`` clipped at 0, output in the compute dtype;
* dropout at the embeddings, the attention probabilities (or the attention
  output, per ``attention_dropout_site``), the attention block output and
  the FFN output, active in ``train()`` mode (flax's ``deterministic=False``).
  ``dropout_impl`` "byte" and "hw" run the byte-threshold kernel K9
  (``ops/dropout.py``); "exact" is ``F.dropout``.  Each site draws its seed
  from the ``generator`` the caller passes for the pass, a layer's seeds
  before the layer runs (so a recomputed layer drops the same elements);
  a :class:`DropoutRows` generator also offsets K9's counter to the pass's
  first row in a data-parallel global batch.

Tensor parallelism (``mesh.model > 1``, ``models/sharding.py``): the
Megatron split of each layer over a model group of positions.  ``query``,
``key``, ``value`` and ``intermediate`` are :class:`ColumnParallel` (each
position holds its rows of the (out, in) weight and takes its slice of the
bias), ``out`` and ``output`` :class:`RowParallel` (each position holds its
columns; the partial products are summed in position order on the first
position, the bias added once after the sum).  A position computes
``num_heads / model`` heads (flash or explicit, under remat as at model
1); the attention's K9 sites draw, for the position's heads or columns,
the counters one device draws for them (:class:`Dropout`).  Embeddings,
LayerNorms, the sites after ``out`` and ``output`` and the heads stay on
the first position.

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
from typing import NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
                                    noop_context_fn)

from colbert_tpu_torch.config import ModelConfig
from colbert_tpu_torch.ops.dropout import hw_dropout, threshold
from colbert_tpu_torch.ops.flash_attention import flash_attention
from colbert_tpu_torch.parallel.collectives import broadcast, reduce


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}[cfg.dtype]


def use_flash(cfg: ModelConfig, seq_len: int) -> bool:
    """The JAX package's dispatch (``colbert_tpu/models/bert.py:122-135``):
    flash only when asked for, at a length that is a multiple of 128."""
    return cfg.attention_impl == "flash" and seq_len % 128 == 0 and seq_len >= 128


def draw_seed(generator: Optional[torch.Generator]) -> int:
    """One 62-bit dropout seed from ``generator`` (torch's default CPU generator if None)."""
    return int(torch.randint(0, 1 << 62, (1,), generator=generator).item())


class DropoutRows(NamedTuple):
    """A pass's dropout stream over rows ``row0 ..`` of a larger batch (a
    data-parallel rank's slice): ``generator`` draws each site's seed, and
    each site's K9 counter starts at the element where row ``row0`` starts,
    so that every rank draws the masks one device draws for the same rows."""
    generator: Optional[torch.Generator]
    row0: int


Seed = Union[int, Tuple[int, int]]  # a site's seed, or (seed, row0) under DropoutRows


class Dropout(nn.Module):
    """Dropout at one site; the identity in ``eval()`` mode or at rate 0.

    "byte"/"hw": drop probability ``round(rate * 256) / 256`` by the K9
    kernel, its mask regenerated in the backward pass.  "exact": ``F.dropout``
    at ``rate``, seeded per call so a step's stream is reproducible (a rank's
    rows fold ``row0`` into the seed and a tensor-parallel position its index:
    their masks differ from every other rank's and position's, not equal to
    one device's).  A call takes the seed :meth:`seed` drew (None: the
    identity), and at a tensor-parallel site its ``part`` ``(p, m, dim)``:
    the tensor is position p's of m equal slices of dim ``dim`` (its heads
    of the probabilities, its columns of the attention output), so K9 draws
    the counters of those elements of the whole tensor."""

    def __init__(self, rate: float, impl: str):
        super().__init__()
        self.rate = rate
        self.impl = impl

    def seed(self, generator) -> Optional[Seed]:
        """This site's seed for one pass, or None where the site is the
        identity; ``generator`` is a ``torch.Generator`` or :class:`DropoutRows`."""
        if not self.training or self.rate <= 0.0:
            return None
        if self.impl != "exact" and threshold(self.rate) <= 0:
            return None
        if isinstance(generator, DropoutRows):
            return draw_seed(generator.generator), generator.row0
        return draw_seed(generator)

    def forward(self, x: torch.Tensor, seed: Optional[Seed],
                part: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
        if seed is None:
            return x
        seed, row0 = seed if isinstance(seed, tuple) else (seed, 0)
        p, m, dim = part if part is not None else (0, 1, 0)
        if self.impl == "exact":
            devices = [x.device] if x.device.type == "cuda" else []
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed((seed + row0 * 0x9E3779B97F4A7C15 + p * 0xBF58476D1CE4E5B9) % (1 << 63))
                return F.dropout(x, self.rate, training=True)
        first = row0 * (x.numel() // x.shape[0]) * m  # the element of the whole tensor where this call's rows start
        if first % 16:
            raise ValueError(f"dropout rows from {row0} start at element {first} of the batch, not a multiple of "
                             f"16 (K9's counter group): a data-parallel rank needs rows of {x.shape[1:]} whose "
                             "slice starts on a group")
        thr = threshold(self.rate)
        if m > 1:
            inner = math.prod(x.shape[dim:])  # elements a run: the position's part of one row of dims < dim
            if inner % 16:
                raise ValueError(f"a tensor-parallel position's dropout slice of {inner} elements a run "
                                 f"({tuple(x.shape)}, dim {dim} split {m} ways) is no whole number of K9's "
                                 "16-element counter groups")
            return hw_dropout(x, seed, thr, (first + p * inner) // 16, inner // 16, m * inner // 16)
        return hw_dropout(x, seed, thr, first // 16) if first else hw_dropout(x, seed, thr)


class Dense(nn.Linear):
    """``nn.Linear`` whose fp32 parameters are cast to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class ColumnParallel(nn.Module):
    """A :class:`Dense` split by output features over a model group
    (Megatron's column-parallel linear): ``weight[p]``, rows ``[p * out/m,
    (p + 1) * out/m)`` of the (out, in) weight, on position p's device; the
    bias, replicated, on the first position, each position taking its slice."""

    def __init__(self, dense: nn.Linear, group: Sequence[torch.device]):
        super().__init__()
        self.group = tuple(group)
        self.per = dense.out_features // len(self.group)
        self.weight = nn.ParameterList(
            nn.Parameter(w.detach().to(d).clone(memory_format=torch.contiguous_format))
            for w, d in zip(dense.weight.split(self.per, 0), self.group))
        self.bias = nn.Parameter(dense.bias.detach().to(self.group[0]).clone())

    def part(self, p: int, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """Position ``p``'s (weight, bias) in ``dtype`` on its device."""
        b = self.bias[p * self.per : (p + 1) * self.per].to(self.group[p], dtype)
        return self.weight[p].to(dtype), b

    def forward(self, x: torch.Tensor, p: int) -> torch.Tensor:
        """Position ``p``'s output features of ``x`` (on its device)."""
        return F.linear(x, *self.part(p, x.dtype))


class RowParallel(nn.Module):
    """A :class:`Dense` split by input features over a model group
    (Megatron's row-parallel linear): ``weight[p]``, columns ``[p * in/m, (p
    + 1) * in/m)`` of the (out, in) weight, on position p's device; the
    bias, replicated, on the first position, added once to the sum of the
    positions' partial products."""

    def __init__(self, dense: nn.Linear, group: Sequence[torch.device]):
        super().__init__()
        self.group = tuple(group)
        per = dense.in_features // len(self.group)
        self.weight = nn.ParameterList(
            nn.Parameter(w.detach().to(d).clone(memory_format=torch.contiguous_format))
            for w, d in zip(dense.weight.split(per, 1), self.group))
        self.bias = nn.Parameter(dense.bias.detach().to(self.group[0]).clone())

    def partial(self, x: torch.Tensor, p: int) -> torch.Tensor:
        """Position ``p``'s partial product (no bias)."""
        return F.linear(x, self.weight[p].to(x.dtype))

    def combine(self, parts: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
        """The partial products summed (fp32, position order, on the first
        position) plus the bias, rounded once to ``dtype``."""
        return (reduce(parts) + self.bias.to(dtype).float()).to(dtype)


def _group(layer: nn.Module) -> Optional[Tuple[torch.device, ...]]:
    """The model group of a tensor-parallel layer, None for a plain one."""
    return layer.group if isinstance(layer, RowParallel) else None


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


def onehot_lookup(ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``model.embedding_impl="onehot"`` (``colbert_tpu/models/bert.py:107-111``):
    the rows of ``weight`` (V, H) at ``ids`` as the product of the one-hot
    ``(..., V)`` in ``weight``'s dtype with the table, so its backward is a
    GEMM too (the table's gradient ``one_hot^T @ grad`` in that dtype).  Each
    output is one product by 1 plus zeros: the lookup's values, bit for bit."""
    one_hot = torch.zeros((*ids.shape, weight.shape[0]), dtype=weight.dtype, device=weight.device)
    return torch.matmul(one_hot.scatter_(-1, ids[..., None], 1.0), weight)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.onehot = cfg.embedding_impl == "onehot"
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.layernorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps)
        self.dropout = Dropout(cfg.hidden_dropout, cfg.dropout_impl)

    def forward(self, input_ids, token_type_ids, dtype: torch.dtype, generator=None) -> torch.Tensor:
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)[None, :]
        word = onehot_lookup if self.onehot else lookup
        x = (
            word(input_ids, self.word_embeddings.weight.to(dtype))
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
        dropout's (:meth:`Dropout.seed`).  Under tensor parallelism each
        position computes its heads' context and its partial ``out`` product."""
        group = _group(self.out)
        if group is None:
            return self.out(self._context(x, bias, seg, seed))
        parts = []
        for p, (xp, dev) in enumerate(zip(broadcast(x, group), group)):
            ctx = self._context(xp, bias.to(dev), None if seg is None else seg.to(dev), seed, p)
            parts.append(self.out.partial(ctx, p))
        return self.out.combine(parts, x.dtype)

    def _context(self, x: torch.Tensor, bias: torch.Tensor, seg: Optional[torch.Tensor], seed: Optional[int],
                 p: Optional[int] = None) -> torch.Tensor:
        """The attention context (B, L, nh / m * hd) of the heads of position
        ``p`` of the model group (all heads for None), before ``out``."""
        B, L, h = x.shape
        m = 1 if p is None else len(self.out.group)
        nh = self.num_heads // m
        hd = h // self.num_heads
        hp = nh * hd
        split = lambda t: t.view(B, L, nh, hd).transpose(1, 2)      # (B, nh, L, hd)
        proj = (lambda layer: layer(x)) if p is None else (lambda layer: layer(x, p))
        if self.cfg.fused_qkv:
            q, k, v = (split(t) for t in self._qkv(x, p).split(hp, dim=-1))
        else:
            q, k, v = split(proj(self.query)), split(proj(self.key)), split(proj(self.value))
        columns = None if p is None else (p, m, 2)  # the position's columns of the (B, L, h) context
        if use_flash(self.cfg, L):
            # the kernel has no probabilities to drop: the JAX package drops
            # the attention output at the same rate
            ctx = flash_attention(q, k, v, seg, seg, 1.0 / math.sqrt(hd)).transpose(1, 2).reshape(B, L, hp)
            return self.dropout(ctx, seed, columns)
        heads = None if p is None else (p, m, 1)  # the position's heads of the (B, nh, L, L) probabilities
        if self.cfg.remat == "attn" and torch.is_grad_enabled():
            # the (B, nh, L, L) logits and probabilities are recomputed in the backward pass
            ctx = checkpoint(self._explicit, q, k, v, bias, seed, heads, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            ctx = self._explicit(q, k, v, bias, seed, heads)
        ctx = ctx.transpose(1, 2).reshape(B, L, hp)
        if self.dropout_site == "output":
            ctx = self.dropout(ctx, seed, columns)
        return ctx

    def _qkv(self, x: torch.Tensor, p: Optional[int] = None) -> torch.Tensor:
        """``model.fused_qkv`` (``colbert_tpu/models/bert.py:162-176``): the
        three projections as one (H, 3H) product, their weights and biases
        concatenated at call time (the parameters stay three ``Dense``), (B,
        L, 3H): q, then k, then v.  At position ``p`` of a model group, its
        own q, k and v slices concatenated: (B, L, 3H / m)."""
        if p is None:
            w = torch.cat([self.query.weight, self.key.weight, self.value.weight]).to(x.dtype)
            b = torch.cat([self.query.bias, self.key.bias, self.value.bias]).to(x.dtype)
        else:
            (wq, bq), (wk, bk), (wv, bv) = (t.part(p, x.dtype) for t in (self.query, self.key, self.value))
            w, b = torch.cat([wq, wk, wv]), torch.cat([bq, bk, bv])
        return F.linear(x, w, b)

    def _explicit(self, q, k, v, bias: torch.Tensor, seed: Optional[int],
                  heads: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
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
            probs = self.dropout(probs, seed, heads)
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
               seeds: Tuple[Optional[Seed], Optional[Seed], Optional[Seed]]) -> torch.Tensor:
        attn = self.attention_dropout(self.attention(x, bias, seg, seeds[0]), seeds[1])
        x = self.attention_layernorm(x + attn, x.dtype)
        y = self.output_dropout(self._mlp(x), seeds[2])
        return self.output_layernorm(x + y, x.dtype)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        """``output(gelu(intermediate(x)))``; under tensor parallelism each
        position takes its intermediate features and its partial product."""
        group = _group(self.output)
        if group is None:
            return self.output(F.gelu(self.intermediate(x)))
        parts = [self.output.partial(F.gelu(self.intermediate(xp, p)), p)
                 for p, xp in enumerate(broadcast(x, group))]
        return self.output.combine(parts, x.dtype)


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

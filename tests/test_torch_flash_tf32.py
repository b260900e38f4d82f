"""The method of route "tf32" of flash attention (K11, K12 and K13 on fp32
inputs), checked on the CPU: is three TF32 products a product accurate
enough at fp32?

The forward: a plain version with each fp32 product as three TF32 products
at K11's blocks (64-key stages, its online softmax stepping over each
stage: the same m as the JAX kernel's 128-key blocks, l and o to fp32
rounding), held to the JAX Pallas forward (run as with ``interpret=True``,
its residuals l and m too) and to ``flash_forward_ref``.

The backward: a plain version with each
fp32 product as three TF32 products (``tests/test_torch_maxsim.py::tf32x3``,
the split of ``ops/maxsim.py::tf32_split``), at the kernels' blocks (K12's
64 keys over 32-query stages, K13's 64 rows over 64-key stages, each
stage's product over rows in a fresh sum added to the running one; the
transposed outputs dV^T = dO^T P, dK^T = Q^T dS, dQ^T = K^T dS^T; P and dS
split as they are written), is held to the JAX Pallas flash backward (the
TPU kernels run as with ``interpret=True``) and to ``flash_backward_ref``.

It is not an emulation of the kernels: it takes torch.exp where they take
ex2.approx, sums each product in fp32 where the tensor cores truncate each
k-step's sum, and keeps the rows' order where the kernels permute it (pos()
in the .cu).  The kernels themselves are held to the plain version on the
card (``tests/test_torch_kernels.py``).

Limits: against JAX's gradients 1e-5 of each tensor's largest entry, as
``tests/test_torch_flash_attention.py::test_plain_backward_matches_jax_grad``
holds the fp32 plain version; against the plain version ``fa.FP32_HEAD_REL``
of each head vector (``fa.fp32_head_rel``), the card's limit.  One TF32
product (hi . hi alone) misses that limit: the check has teeth.
"""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import config as jax_config
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

from colbert_tpu_torch.ops import flash_attention as fa
from tests.test_torch_maxsim import tf32x3

torch.set_num_threads(2)
# the first CPU exp after JAX can be off (tests/test_torch_flash_attention.py): made first here
torch.exp(torch.zeros(8))
torch.exp(torch.zeros(1 << 16))

SCALE = 0.125
KEYS_K11 = 64                   # K11's stage of keys
KEYS_K12, QUERIES_K12 = 64, 32  # K12's block of keys and stage of queries
ROWS_K13, KEYS_K13 = 64, 64     # K13's block of query rows and stage of keys
STAGE_KEYS = {32: 64, 64: 64, 128: 32}  # K11's and K13's stage of keys by head dim (tf::Hd<HD>::KEYS)


@contextlib.contextmanager
def interpret_pallas():
    """Every ``pallas_call`` under it runs as with ``interpret=True``
    (as ``tests/test_torch_flash_attention.py`` runs the JAX kernels)."""
    prev = jax_config.pallas_tpu_interpret_mode_context_manager.swap_local(True)
    try:
        yield
    finally:
        jax_config.pallas_tpu_interpret_mode_context_manager.set_local(prev)


def prod3(a: torch.Tensor, b: torch.Tensor, terms: int = 3) -> torch.Tensor:
    """``a @ b`` as three TF32 products (``terms=1``: hi . hi alone)."""
    return tf32x3("...ij,...jk->...ik", a, b, terms)


def tf32x3_forward(q, k, v, q_seg, kv_seg, scale, terms=3, keys=KEYS_K11):
    """(o, l, m) fp32 by three TF32 products a product at K11's ``keys``-key
    stages (64; 32 at head dim 128): S = Q K^T, the mask, the online softmax
    over the stage (m_next, p = exp(s - m_next), l_corr, l_next, 1 /
    l_next), O rescaled and P V added times 1 / l_next; ``terms=1`` keeps hi
    . hi alone."""
    q, k, v = (t.float() for t in (q, k, v))
    B, nh, Lq, _ = q.shape
    m = torch.full((B, nh, Lq), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros((B, nh, Lq, v.shape[-1]))
    for k0 in range(0, k.shape[2], keys):
        ks = slice(k0, k0 + keys)
        visible = q_seg[:, None, :, None] == kv_seg[:, None, None, ks]
        s = prod3(q, k[:, :, ks].transpose(-1, -2), terms) * scale + torch.where(visible, 0.0, fa.MASK_VALUE)
        m_next = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_next[..., None])
        l_corr = torch.exp(m - m_next) * l
        l_next = p.sum(-1) + l_corr
        inv = torch.where(l_next == 0.0, 1.0, torch.ones_like(l_next) / l_next)
        acc = acc * (l_corr * inv)[..., None] + prod3(p, v[:, :, ks], terms) * inv[..., None]
        m, l = m_next, l_next
    return acc, l, m


def tf32x3_backward(q, k, v, q_seg, kv_seg, scale, l, m, do, di, terms=3, keys_k13=KEYS_K13):
    """(dq, dk, dv) fp32 by three TF32 products a product at the kernels'
    blocks (see the module docstring; K13's stage ``keys_k13`` keys, 32 at
    head dim 128); ``terms=1`` keeps hi . hi alone."""
    q, k, v, do = (t.float() for t in (q, k, v, do))
    Lq, Lk = q.shape[2], k.shape[2]
    inv_l = torch.ones_like(l) / l
    T = lambda t: t.transpose(-1, -2)

    def p_of(s, qs, ks, rows_are_keys):
        if rows_are_keys:  # s is S^T: (keys, queries)
            visible = kv_seg[:, None, ks, None] == q_seg[:, None, None, qs]
            mm, il = m[:, :, None, qs], inv_l[:, :, None, qs]
        else:
            visible = q_seg[:, None, qs, None] == kv_seg[:, None, None, ks]
            mm, il = m[:, :, qs, None], inv_l[:, :, qs, None]
        return torch.exp(s * scale + torch.where(visible, 0.0, fa.MASK_VALUE) - mm) * il

    dk, dv, dq = torch.zeros_like(k), torch.zeros_like(v), torch.zeros_like(q)
    for k0 in range(0, Lk, KEYS_K12):  # K12
        ks = slice(k0, k0 + KEYS_K12)
        acc_dv = torch.zeros(q.shape[:2] + (q.shape[3], KEYS_K12))
        acc_dk = torch.zeros_like(acc_dv)
        for q0 in range(0, Lq, QUERIES_K12):
            qs = slice(q0, q0 + QUERIES_K12)
            p = p_of(prod3(k[:, :, ks], T(q[:, :, qs]), terms), qs, ks, True)
            ds = (prod3(v[:, :, ks], T(do[:, :, qs]), terms) - di[:, :, None, qs]) * p * scale
            acc_dv = acc_dv + prod3(T(do[:, :, qs]), T(p), terms)
            acc_dk = acc_dk + prod3(T(q[:, :, qs]), T(ds), terms)
        dv[:, :, ks], dk[:, :, ks] = T(acc_dv), T(acc_dk)
    for q0 in range(0, Lq, ROWS_K13):  # K13
        qs = slice(q0, q0 + ROWS_K13)
        acc = torch.zeros(q.shape[:2] + (q.shape[3], ROWS_K13))
        for k0 in range(0, Lk, keys_k13):
            ks = slice(k0, k0 + keys_k13)
            p = p_of(prod3(q[:, :, qs], T(k[:, :, ks]), terms), qs, ks, False)
            ds = (prod3(do[:, :, qs], T(v[:, :, ks]), terms) - di[:, :, qs, None]) * p * scale
            acc = acc + prod3(T(k[:, :, ks]), T(ds), terms)
        dq[:, :, qs] = T(acc)
    return dq, dk, dv


def _inputs(seed, L, pad, B=2, nh=2, hd=64):
    """q, k, v, the cotangent w (fp32, numpy) and segment ids: batch row 0
    padded at ``pad`` (None: no padding), row 1 at L // 2 + 1."""
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(0, 1, (B, nh, L, hd)).astype(np.float32) for _ in range(4))
    seg = np.ones((B, L), np.int32)
    if pad is not None:
        seg[0, pad:] = 0
    seg[1, L // 2 + 1:] = 0
    return q, k, v, w, seg


def _torch_backward(q, k, v, w, seg, **kw):
    qt, kt, vt, do = (torch.from_numpy(x) for x in (q, k, v, w))
    s = torch.from_numpy(seg)
    o, l, m = fa.flash_forward_ref(qt, kt, vt, s, s, SCALE)
    args = (qt, kt, vt, s, s, SCALE, l, m, do, fa.flash_di(o, do))
    return tf32x3_backward(*args, **kw), fa.flash_backward_ref(*args)


def _jax_forward(q, k, v, seg):
    """The JAX Pallas forward's (o, l, m), interpreted, at its default blocks (128)."""
    from jax.experimental.pallas.ops.tpu.flash_attention import _flash_attention_impl

    sj = jnp.asarray(seg)
    with interpret_pallas():
        out = _flash_attention_impl(*(jnp.asarray(x) for x in (q, k, v)), None, SegmentIds(sj, sj), True, False,
                                    SCALE, 1, 128, 128, 128, False)
    return [torch.from_numpy(np.array(x)) for x in out]


def _tf32_forward_emulation_matches_jax_and_the_plain_version(L, pad, hd=64):
    q, k, v, _, seg = _inputs(19 * L + (pad or 0) + (hd != 64) * hd, L, pad, hd=hd)
    s = torch.from_numpy(seg)
    o, l, m = tf32x3_forward(*(torch.from_numpy(x) for x in (q, k, v)), s, s, SCALE, keys=STAGE_KEYS[hd])
    for name, want in (("jax", _jax_forward(q, k, v, seg)),
                       ("plain", fa.flash_forward_ref(*(torch.from_numpy(x) for x in (q, k, v)), s, s, SCALE))):
        wo, wl, wm = want
        assert o.shape == wo.shape and l.shape == wl.shape == m.shape == wm.shape, name
        assert fa.fp32_head_rel(o, wo) <= fa.FP32_HEAD_REL, name
        assert float(((l - wl).abs() / wl).max()) <= fa.FP32_HEAD_REL, name
        assert float(((m - wm).abs() / wm.abs().clamp_min(1.0)).max()) <= fa.FP32_HEAD_REL, name


@pytest.mark.parametrize("L,pad", [(128, 100), (256, 129), (384, 200), (384, None)])
def test_tf32_forward_emulation_matches_jax_and_the_plain_version(L, pad):
    """K11's three TF32 products a product at its 64-key stages against the
    JAX Pallas forward at fp32 and against ``flash_forward_ref``: o within
    ``fa.FP32_HEAD_REL`` of each head vector (the card's limit), l and m
    within it too, relative (m's floored at 1): three TF32 products move a
    logit by ~2^-21 of its terms, so m and l move by that much, where fp32
    FMAs kept them within 1e-6."""
    _tf32_forward_emulation_matches_jax_and_the_plain_version(L, pad)


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("L,pad", [(128, 100), (384, 200), (384, None)])
def test_tf32_forward_emulation_matches_jax_and_the_plain_version_at_head_dims(L, pad, hd):
    """As above at head dims 32 (64-key stages) and 128 (32-key stages)."""
    _tf32_forward_emulation_matches_jax_and_the_plain_version(L, pad, hd)


def _tf32_forward_one_product_misses_the_card_limit(L, pad, hd=64):
    q, k, v, _, seg = _inputs(23 * L + pad + (hd != 64) * hd, L, pad, hd=hd)
    s = torch.from_numpy(seg)
    args = (*(torch.from_numpy(x) for x in (q, k, v)), s, s, SCALE)
    want = fa.flash_forward_ref(*args)[0]
    keys = STAGE_KEYS[hd]
    assert fa.fp32_head_rel(tf32x3_forward(*args, keys=keys)[0], want) <= fa.FP32_HEAD_REL
    assert fa.fp32_head_rel(tf32x3_forward(*args, terms=1, keys=keys)[0], want) > 10 * fa.FP32_HEAD_REL


@pytest.mark.parametrize("L,pad", [(128, 100), (384, 257)])
def test_tf32_forward_one_product_misses_the_card_limit(L, pad):
    """hi . hi alone (one TF32 product) misses ``fa.FP32_HEAD_REL`` on o by
    far, so the forward's check has teeth; three products meet it."""
    _tf32_forward_one_product_misses_the_card_limit(L, pad)


@pytest.mark.parametrize("hd", [32, 128])
def test_tf32_forward_one_product_misses_the_card_limit_at_head_dims(hd):
    """As above at head dims 32 and 128."""
    _tf32_forward_one_product_misses_the_card_limit(384, 257, hd)


def _tf32_emulation_matches_jax_grad(L, pad, hd=64):
    q, k, v, w, seg = _inputs(13 * L + (pad or 0) + (hd != 64) * hd, L, pad, hd=hd)
    sj = jnp.asarray(seg)

    def f(q, k, v):
        o = jax_flash(q, k, v, segment_ids=SegmentIds(sj, sj), sm_scale=SCALE)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))

    with interpret_pallas():
        want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    got, _ = _torch_backward(q, k, v, w, seg, keys_k13=STAGE_KEYS[hd])
    for name, g, wj in zip(("dq", "dk", "dv"), got, want):
        wt = torch.from_numpy(np.array(wj))
        assert g.dtype == torch.float32 and g.shape == wt.shape
        assert float((g - wt).abs().max()) <= 1e-5 * float(wt.abs().max()), name


@pytest.mark.parametrize("L,pad", [(128, 100), (256, 129), (384, 200), (384, None)])
def test_tf32_emulation_matches_jax_grad(L, pad):
    """Three TF32 products a product against JAX's Pallas flash backward at
    fp32 (jax.grad through the interpreted kernels), every position
    compared."""
    _tf32_emulation_matches_jax_grad(L, pad)


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("L,pad", [(128, 100), (384, 200)])
def test_tf32_emulation_matches_jax_grad_at_head_dims(L, pad, hd):
    """As above at head dims 32 and 128 (K13's 32-key stages at 128)."""
    _tf32_emulation_matches_jax_grad(L, pad, hd)


def _tf32_emulation_within_the_card_limit(L, pad, hd=64):
    q, k, v, w, seg = _inputs(17 * L + pad + (hd != 64) * hd, L, pad, hd=hd)
    got, want = _torch_backward(q, k, v, w, seg, keys_k13=STAGE_KEYS[hd])
    one, _ = _torch_backward(q, k, v, w, seg, terms=1, keys_k13=STAGE_KEYS[hd])
    for name, g, o, r in zip(("dq", "dk", "dv"), got, one, want):
        assert fa.fp32_head_rel(g, r) <= fa.FP32_HEAD_REL, name
        assert fa.fp32_head_rel(o, r) > 10 * fa.FP32_HEAD_REL, name


@pytest.mark.parametrize("L,pad", [(128, 100), (256, 129), (384, 200), (384, 257)])
def test_tf32_emulation_within_the_card_limit(L, pad):
    """Three TF32 products a product against the fp32 plain version within
    ``fa.FP32_HEAD_REL`` of each head vector, the limit the card's kernels
    are held to; hi . hi alone misses it by far (TF32's 11 bits: ~1e-3)."""
    _tf32_emulation_within_the_card_limit(L, pad)


@pytest.mark.parametrize("hd", [32, 128])
@pytest.mark.parametrize("L,pad", [(256, 129), (384, 257)])
def test_tf32_emulation_within_the_card_limit_at_head_dims(L, pad, hd):
    """As above at head dims 32 and 128."""
    _tf32_emulation_within_the_card_limit(L, pad, hd)


def test_tf32_emulation_blocks_cover_the_kernels_shapes():
    """The plain versions' blocks are the kernels' (``csrc/flash_attention.cu``,
    namespace tf): K11 64-key stages (its 128-row blocks hold whole rows),
    K12 64 keys and 32-query stages, K13 64 rows and 64-key stages; every
    length the kernels take (a multiple of 128) is whole blocks and stages
    of all three."""
    text = (Path(fa.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu").read_text()
    for line in ("constexpr int RB = 64;", "constexpr int QT = 32;", "constexpr int KT = 64;",
                 "static constexpr int ROWS_BLK = 2 * RB;"):
        assert line in text, line
    for L in (128, 256, 384, 512):
        assert L % KEYS_K11 == L % KEYS_K12 == L % QUERIES_K12 == L % ROWS_K13 == L % KEYS_K13 == L % 128 == 0


def test_tf32_emulation_stages_by_head_dim():
    """The emulation's stage of keys by head dim (K11's and K13's) is the
    kernels' (``tf::Hd<HD>::KEYS`` in the .cu: 32 at head dim 128, for
    shared memory), and each divides every length the kernels take."""
    text = (Path(fa.__file__).resolve().parents[1] / "csrc" / "flash_attention.cu").read_text()
    assert "static constexpr int KEYS = HD == 128 ? 32 : KT;" in text
    assert STAGE_KEYS == {hd: 32 if hd == 128 else KEYS_K11 for hd in fa.HEAD_DIMS}
    assert all(128 % keys == 0 for keys in STAGE_KEYS.values())

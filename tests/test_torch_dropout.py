"""Byte-threshold dropout (K9) of the port: its Philox stream, its semantics
against the JAX package's byte dropout, and the model's dropout sites.

On CPU tensors ``hw_dropout`` runs its plain version, which computes the
CUDA kernel's Philox4x32-10 stream (the card test holds the two bit-equal,
``tests/test_torch_kernels.py``).  The TPU kernel draws from the TPU's
hardware generator, which neither the CPU nor the card has, so the parity
with the JAX package is semantic: the same threshold, the same scale in
the input's dtype, the same keep rate, zero residual.  Keep rates are held
within 5 sigma of ``(256 - thr) / 256``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu_torch.config import ModelConfig, MultiviewConfig
from colbert_tpu_torch.models import bert as tbert
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.ops import dropout as dr

# Random123's known-answer vectors for philox4x32-10: (counter, key) -> output
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    got = dr.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in ctr], key)
    assert tuple(int(w) for w in got) == want


def test_mask_bytes_unpack_words_low_byte_first():
    seed = 0xDEADBEEF_01234567
    i = torch.arange(3, dtype=torch.int64)
    z = torch.zeros_like(i)
    words = dr.philox4x32_10((i, z, z, z), (seed & 0xFFFFFFFF, seed >> 32))
    b = dr.mask_bytes(40, seed)
    assert b.dtype == torch.uint8 and b.shape == (40,)
    for e in range(40):
        g, j = divmod(e, 16)
        assert int(b[e]) == (int(words[j // 4][g]) >> (8 * (j % 4))) & 0xFF


def _sigma_ok(keep_frac, n, thr):
    p = (256 - thr) / 256
    return abs(keep_frac - p) <= 5 * np.sqrt(p * (1 - p) / n)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16, torch.float64])
@pytest.mark.parametrize("thr", [1, 26, 128, 255])
def test_keep_rate_and_scale(dtype, thr):
    x = torch.from_numpy(np.random.default_rng(thr).uniform(0.5, 2.0, size=(64, 257))).to(dtype)
    y = dr.hw_dropout_ref(x, 1234 + thr, thr)
    kept = y != 0
    assert _sigma_ok(float(kept.float().mean()), x.numel(), thr)
    scale = torch.tensor(256.0 / (256.0 - thr), dtype=torch.float64).to(dtype)
    assert y.dtype == dtype
    assert torch.equal(y[kept], x[kept] * scale)


def test_seed_determines_the_mask():
    x = torch.ones(5000)
    a, b = dr.hw_dropout(x, 7, 26), dr.hw_dropout(x, 7, 26)
    c = dr.hw_dropout(x, 8, 26)
    d = dr.hw_dropout(x, 7 + (1 << 32), 26)  # the key's high word counts too
    assert torch.equal(a, b)
    assert not torch.equal(a, c) and not torch.equal(a, d)


def test_backward_regenerates_the_forward_mask():
    x = torch.randn(3, 37, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: dr.hw_dropout(t, 99, 26), (x,))
    y = dr.hw_dropout(x, 99, 26)
    g = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, g)
    keep = dr.mask_bytes(x.numel(), 99).view(x.shape) >= 26
    assert torch.equal(keep, y.detach() != 0)
    assert torch.equal(dx, torch.where(keep, g * (256.0 / 230.0), torch.zeros_like(g)))


def test_rejects_bad_threshold_and_seed():
    with pytest.raises(ValueError, match="threshold"):
        dr.hw_dropout(torch.ones(4), 1, 256)
    with pytest.raises(ValueError, match="seed"):
        dr.hw_dropout(torch.ones(4), -1, 26)


@pytest.mark.parametrize("rate", [0.1, 0.05, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_same_semantics_as_jax_byte_dropout(rate, dtype):
    """JAX's FastDropout (the CPU stand-in of its hw kernel) and the port
    agree on the threshold, the kept values (same scale in the dtype) and
    the keep rate; only the random stream differs."""
    from colbert_tpu.models.bert import FastDropout

    x = np.random.default_rng(0).uniform(0.5, 2.0, size=(32, 300)).astype(np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    yj = np.asarray(FastDropout(rate, impl="byte").apply({}, jx, False, rngs={"dropout": jax.random.PRNGKey(3)}),
                    np.float32)
    thr = dr.threshold(rate)
    assert thr == int(round(rate * 256))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    yt = dr.hw_dropout(tx, 5, thr).float().numpy()
    both = (yj != 0) & (yt != 0)
    assert both.sum() > 0.3 * x.size
    np.testing.assert_array_equal(yj[both], yt[both])
    assert _sigma_ok(float((yj != 0).mean()), x.size, thr) and _sigma_ok(float((yt != 0).mean()), x.size, thr)


CFG = ModelConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                  max_position_embeddings=32, dim=16, dtype="float32")
MV = MultiviewConfig(enabled=True, q_view=4, d_view=4)


def _model(cfg):
    m = ColbertModel(cfg, MV)
    m.init_weights(torch.Generator().manual_seed(0))
    return m


def _batch():
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(1, 100, size=(3, 12)))
    attn = torch.ones(3, 12, dtype=torch.int64)
    attn[1, 8:] = 0
    return ids, attn


def test_rate_zero_and_eval_mode_are_identity():
    ids, attn = _batch()
    zero = dataclasses.replace(CFG, hidden_dropout=0.0, attention_dropout=0.0)
    with torch.no_grad():
        want = _model(zero).train().doc(ids, attn, generator=torch.Generator().manual_seed(1))
        got_eval = _model(CFG).eval().doc(ids, attn, generator=torch.Generator().manual_seed(1))
        got_train = _model(CFG).train().doc(ids, attn, generator=torch.Generator().manual_seed(1))
    assert torch.equal(got_eval, want)
    assert not torch.equal(got_train, want)
    x = torch.randn(5)
    assert tbert.Dropout(0.0, "byte").train()(x, None) is x
    assert tbert.Dropout(0.001, "byte").train()(x, None) is x  # round(0.256) = 0: nothing to drop


@pytest.mark.parametrize("site", ["probs", "output"])
def test_every_site_runs_the_kernel_forward_and_backward(monkeypatch, site):
    """1 embedding site + 3 per layer, each forward and backward: the count
    ``chip_smoke.py`` holds the card's launches to."""
    calls = []
    orig = dr._apply
    monkeypatch.setattr(dr, "_apply", lambda x, s, t: calls.append(tuple(x.shape)) or orig(x, s, t))
    model = _model(dataclasses.replace(CFG, attention_dropout_site=site)).train()
    ids, attn = _batch()
    model.query(ids, attn, generator=torch.Generator().manual_seed(0)).sum().backward()
    sites = 1 + 3 * CFG.num_layers
    assert len(calls) == 2 * sites
    probs = (3, CFG.num_heads, 12, 12)
    assert calls[:sites].count(probs) == (CFG.num_layers if site == "probs" else 0)


def test_generator_reproduces_the_stream():
    ids, attn = _batch()
    model = _model(CFG).train()
    with torch.no_grad():
        a = model.doc(ids, attn, generator=torch.Generator().manual_seed(11))
        b = model.doc(ids, attn, generator=torch.Generator().manual_seed(11))
        c = model.doc(ids, attn, generator=torch.Generator().manual_seed(12))
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_exact_impl_is_seeded_dropout():
    ids, attn = _batch()
    model = _model(dataclasses.replace(CFG, dropout_impl="exact")).train()
    state = torch.random.get_rng_state()
    with torch.no_grad():
        a = model.doc(ids, attn, generator=torch.Generator().manual_seed(11))
        b = model.doc(ids, attn, generator=torch.Generator().manual_seed(11))
        c = model.doc(ids, attn, generator=torch.Generator().manual_seed(12))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(torch.random.get_rng_state(), state)  # the global stream is left alone

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
    monkeypatch.setattr(dr, "_apply", lambda x, s, t, *a: calls.append(tuple(x.shape)) or orig(x, s, t, *a))
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


# ---- route "packed" of the CUDA kernel, emulated word by word in numpy ----
#
# The card's route "packed" (csrc/dropout.cu) compares each 32-bit Philox
# word with thr four bytes at once (SWAR), spreads each byte's keep bit to a
# 16- or 32-bit lane mask (PRMT with sign replication), multiplies two bf16 /
# fp16 elements at once (HMUL2, one rounding to nearest) or one fp32
# element, and ANDs the product with its mask.  These tests run that
# arithmetic on numpy integers and hold it bit-equal to the plain version
# (NaN compared by position): the card tests hold the kernel to the same.

_UINT = {torch.float32: np.uint32, torch.bfloat16: np.uint16, torch.float16: np.uint16}
_INT = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.float16: torch.int16}


def _keep_bits(w, thr):
    """The SWAR compare: bit 7 of each byte set where that byte of ``w`` is >= thr."""
    bias = np.uint32((0x80 - (thr & 0x7F)) * 0x01010101)
    d = (w & np.uint32(0x7F7F7F7F)) + bias  # no carry between bytes
    return (w & d) if thr >= 128 else (w | d)


def _prmt_sign(a, sel):
    """PRMT with every selector nibble's sign bit set: byte k of the result is
    0xFF where bit 7 of byte (nibble k & 3) of ``a`` is set, else 0."""
    out = np.zeros_like(a)
    for k in range(4):
        src = (sel >> (4 * k)) & 3
        out |= ((a >> np.uint32(8 * src + 7)) & np.uint32(1)) * np.uint32(0xFF << (8 * k))
    return out


def _bf16_round(f32):
    """fp32 -> bf16 bits, round to nearest even (quiet NaN for NaN)."""
    u = f32.view(np.uint32)
    rounded = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) >> np.uint32(16)).astype(np.uint16)
    return np.where(np.isnan(f32), ((u >> np.uint32(16)) | np.uint32(0x40)).astype(np.uint16), rounded)


def _packed_emulation(x: torch.Tensor, seed: int, thr: int) -> np.ndarray:
    """Route "packed" on ``x`` (CPU), chunk by chunk as a lane takes them,
    returned as the output's raw bits.  A 16-byte chunk is part ``c % parts``
    of group ``c // parts`` (parts = 2 for bf16/fp16, 4 for fp32) and takes
    that part's mask words of its group's Philox output."""
    n = x.numel()
    uint = _UINT[x.dtype]
    parts = x.element_size()
    pad = -n % 16
    words = np.ascontiguousarray(dr.mask_bytes(n + pad, seed).numpy()).view("<u4").reshape(-1, 4)
    raw = np.concatenate([x.reshape(-1).view(_INT[x.dtype]).numpy().view(uint), np.zeros(pad, uint)])
    chunks = raw.view("<u4").reshape(-1, 4)  # four 32-bit words of data a chunk
    c = np.arange(len(chunks))
    r, part = words[c // parts], c % parts
    if parts == 2:  # words 2 part, 2 part + 1; a data word holds elements 2p, 2p + 1
        ka = _keep_bits(np.where(part == 1, r[:, 2], r[:, 0]), thr)
        kb = _keep_bits(np.where(part == 1, r[:, 3], r[:, 1]), thr)
        masks = np.stack([_prmt_sign(ka, 0x9988), _prmt_sign(ka, 0xBBAA), _prmt_sign(kb, 0x9988),
                          _prmt_sign(kb, 0xBBAA)], axis=1)
    else:  # word `part`; a data word holds one element
        k = _keep_bits(r[c, part], thr)
        masks = np.stack([_prmt_sign(k, 0x8888 + 0x1111 * e) for e in range(4)], axis=1)
    scale = dr._scale(thr, x.dtype)
    with np.errstate(over="ignore", invalid="ignore"):  # inf and NaN products, as on the card
        prod = _packed_product(chunks, scale, x.dtype)
    return (prod & masks).reshape(-1).view(uint)[:n]


def _packed_product(chunks, scale, dtype):
    """HMUL2 on each 32-bit word (two bf16/fp16 elements, each rounded once to
    nearest from the exact fp32 product) or FMUL (one fp32 element)."""
    if dtype == torch.float32:
        return (chunks.view(np.float32) * np.float32(scale)).view(np.uint32)
    halves = chunks.view(np.uint16)
    if dtype == torch.bfloat16:
        prod = _bf16_round((halves.astype(np.uint32) << np.uint32(16)).view(np.float32) * np.float32(scale))
    else:
        prod = (halves.view(np.float16).astype(np.float32) * np.float32(scale)).astype(np.float16).view(np.uint16)
    return np.ascontiguousarray(prod).view("<u4")


def _assert_same_bits(got_bits: np.ndarray, want: torch.Tensor):
    ints = np.int32 if want.element_size() == 4 else np.int16
    got = torch.from_numpy(np.ascontiguousarray(got_bits).view(ints)).view(want.dtype)
    assert dr.same_bits(got, want.reshape(-1))


def _special_input(dtype, n, seed):
    fi = torch.finfo(dtype)
    special = torch.tensor([fi.tiny / 2, -fi.tiny / 3, fi.tiny / 64, fi.tiny, -fi.tiny, 0.0, -0.0, float("inf"),
                            -float("inf"), float("nan"), fi.max, -fi.max], dtype=torch.float64)
    x = torch.from_numpy(np.random.default_rng(seed).normal(size=n))
    x[::5] = special.repeat(-(-x[::5].numel() // special.numel()))[: x[::5].numel()]
    return x.to(dtype)


def test_swar_compare_every_byte_and_threshold():
    b = np.arange(256, dtype=np.uint8)
    words = b.view("<u4")  # bytes 0..255, four to a word
    for thr in range(1, 256):
        keep = (_keep_bits(words, thr)[:, None] >> np.arange(7, 32, 8, dtype=np.uint32)) & 1
        np.testing.assert_array_equal(keep.reshape(-1).astype(bool), b >= thr, err_msg=f"thr {thr}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_packed_word_path_every_threshold(dtype):
    x = torch.from_numpy(np.random.default_rng(3).normal(size=48)).to(dtype)
    for thr in range(1, 256):
        seed = 0x0123_4567_89AB_CDEF + thr
        _assert_same_bits(_packed_emulation(x, seed, thr), dr.hw_dropout_ref(x, seed, thr))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_packed_word_path_special_values(dtype):
    """Subnormals, +-0, +-inf, NaN and +-max: the packed product rounds once
    to nearest and keeps subnormals; a dropped element is +0.0, a kept -0.0
    stays -0.0."""
    x = _special_input(dtype, 4000, 5)
    for thr in (1, 26, 128, 200, 255):
        _assert_same_bits(_packed_emulation(x, 77 + thr, thr), dr.hw_dropout_ref(x, 77 + thr, thr))


@pytest.mark.parametrize("n", [1, 15, 17, 31, 33, 1001])
def test_packed_word_path_odd_counts(n):
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = _special_input(dtype, n, n)
        _assert_same_bits(_packed_emulation(x, 2**64 - 1 - n, 51), dr.hw_dropout_ref(x, 2**64 - 1 - n, 51))


def test_cached_scale_equals_keep_scale():
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.float64):
        for thr in range(1, 256):
            assert dr._scale(thr, dtype) == dr.keep_scale(thr, dtype)
            assert dr._scale(thr, dtype) == dr.keep_scale(thr, dtype)  # the cached value, the second time


def test_cpu_tensors_take_the_plain_version():
    counters = [dr.hw_dropout.launches, *dr.route_launches.values()]
    before = [c.value for c in counters]
    x = torch.randn(3, 50, requires_grad=True)
    y = dr.hw_dropout(x, 5, 26)
    g = torch.randn(3, 50)
    y.backward(g)
    assert y.grad_fn is not None
    assert torch.equal(y, dr.hw_dropout_ref(x.detach(), 5, 26))
    assert torch.equal(x.grad, dr.hw_dropout_ref(g, 5, 26))  # the same mask, regenerated
    with torch.no_grad():
        assert torch.equal(dr.hw_dropout(x, 6, 26), dr.hw_dropout_ref(x.detach(), 6, 26))
    assert [c.value for c in counters] == before


def test_high_seed_reaches_the_launch_unchanged(monkeypatch):
    """A seed in [2**63, 2**64) passes the guard, reaches ``_launch`` (a
    tensor off the CPU) and the C function's argument as the same int."""
    seed = (1 << 64) - 3
    seen = []
    monkeypatch.setattr(dr, "_launch", lambda x, s, t, **kw: seen.append((s, t)) or torch.empty_like(x))
    dr.hw_dropout(torch.empty(4, 5, device="meta"), seed, 26)
    dr.hw_dropout(torch.empty(4, 5, device="meta", requires_grad=True), 1 << 63, 26)
    assert seen == [(seed, 26), ((1 << 63), 26)]
    monkeypatch.undo()

    args = []
    monkeypatch.setattr(dr, "_fn", lambda *a: args.append(a) or 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 1234, raising=False)
    before = dr.route_launches["simple"].value
    x = torch.ones(40, dtype=torch.bfloat16)
    y = dr._launch(x, seed, 200, route="simple")
    assert y.shape == x.shape and y.dtype == x.dtype and y.data_ptr() != x.data_ptr()
    (a,) = args
    assert a[2:] == (40, 1, seed, 200, dr.keep_scale(200, torch.bfloat16), dr.ROUTES.index("simple"), -1, 1234,
                     0, 0, 0, 0, 0)
    assert dr.route_launches["simple"].value == before + 1

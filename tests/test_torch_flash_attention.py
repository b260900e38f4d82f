"""The port's flash attention (K11-K13's plain versions), its model path
(``model.attention_impl="flash"``) and ``model.remat`` against the JAX
package, on the CPU.

The JAX side runs ``jax.experimental.pallas.ops.tpu.flash_attention`` (the
Pallas TPU kernels the JAX encoder reaches under flash) in Pallas's
interpret mode, as with ``interpret=True`` (:func:`interpret_pallas`); the
JAX encoder's ``_use_flash`` refuses a CPU backend, so the model tests
patch it, in the test alone, to its TPU rule (flash at lengths that are
multiples of 128).  Inputs come from numpy seeds.

Limits:

* the plain forward and backward against the interpreted kernels, every
  position compared, the padded ones included: fp32 within 1e-5 (o
  absolute; dq, dk, dv of each tensor's largest entry), both sides summing
  fp32 products in nearly the same order; bf16 within 2 bf16 ulps of the
  magnitude of each element's head vector (its row of hd values), and all
  but 1e-3 of the elements within 2 bf16 ulps of their own magnitude.  Not
  every element: where the two exponentials or dot products differ in the
  last fp32 bit, a p (or ds) right at a bf16 rounding boundary rounds the
  other way, and moves its whole row by ~2^-8 of one term; an element that
  cancels to near zero then differs by many of its own ulps (measured here:
  up to 77 at L 384, 3 elements of 98,304; on the card the kernel against
  the plain version: 368 ulps in 7.5e-5 of the elements of o at (68, 12,
  384, 64), at most 1 ulp of the row).  The head vector's magnitude is
  floored at 2^-10 of the tensor's largest entry: a query that sees only
  itself has p = 1 and a gradient that cancels to fp32 noise;
* the models with flash against the JAX models with flash (weights by
  ``models/convert.py``): fp32 within 1e-4 (retriever) and 1e-5 (CE logits);
  bf16 per-token cosine > 0.99 (the dense layers round at different places,
  as ``tests/test_torch_models.py``) and CE logits within 1e-2; gradients of
  one deterministic train step within 1e-4 of each tensor's largest entry
  (the key biases, whose exact gradient is zero: 1e-5 of the largest
  gradient).  Each test runs its own JAX side (the suite spreads tests over
  workers, so a shared fixture would be built in each);
* remat: gradients bit-equal to no remat (dropout on, a seeded generator).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import config as jax_config
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

import colbert_tpu.config as jcfg
import colbert_tpu.models.bert as jbert
from colbert_tpu.models import ColbertModel as FlaxColbert
from colbert_tpu.models import CrossEncoderModel as FlaxCE
from colbert_tpu_torch.config import ModelConfig, MultiviewConfig
from colbert_tpu_torch.models import bert as tbert
from colbert_tpu_torch.models.ce import CrossEncoderModel
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.convert import state_dict_from_jax_params
from colbert_tpu_torch.ops import flash_attention as fa

# two intra-op threads a worker: the suite runs in several workers beside JAX's thread pools
torch.set_num_threads(2)
# torch's first CPU exp, made after JAX had run in the process, came out up to 1e-4 off now and
# then (7 of 60 fresh processes; none of 60 that made these calls first): the fp32 limits catch it
torch.exp(torch.zeros(8))
torch.exp(torch.zeros(1 << 16))

SCALE = 0.125  # 1 / sqrt(64)


@contextlib.contextmanager
def interpret_pallas():
    """Every ``pallas_call`` under it runs as with ``interpret=True``:
    Pallas's HLO interpreter, as the JAX package's and the port's other tests
    run TPU kernels on the CPU.  TPU interpret mode
    (``force_tpu_interpret_mode``) simulates the TPU's memory in state that
    the whole process shares, served from callback threads; a run of this
    file under it hung once, every worker idle.  The switch has no public
    form: this does what ``force_tpu_interpret_mode`` does, with ``True``
    for its parameters."""
    prev = jax_config.pallas_tpu_interpret_mode_context_manager.swap_local(True)
    try:
        yield
    finally:
        jax_config.pallas_tpu_interpret_mode_context_manager.set_local(prev)


def assert_bf16_close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Within 2 bf16 ulps of each element's head-vector magnitude (floored at
    2^-10 of the tensor's largest entry), and all but 1e-3 of the elements
    within 2 ulps of their own magnitude (``fa.close_in_head_ulps``)."""
    worst, share, _ = fa.close_in_head_ulps(got, want)
    assert worst <= 2.0, f"{what}: {worst} ulps of its head vector"
    assert share <= 1e-3, f"{what}: {share} of the elements beyond 2 ulps of their own magnitude"


def _inputs(seed, L, pad, dtype, B=2, nh=2, hd=64):
    """q, k, v, the cotangent w (fp32, numpy) and segment ids: batch row 0
    padded at ``pad`` (None: no padding), row 1 at L // 2 + 1."""
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(0, 1, (B, nh, L, hd)).astype(np.float32) for _ in range(4))
    seg = np.ones((B, L), np.int32)
    if pad is not None:
        seg[0, pad:] = 0
    seg[1, L // 2 + 1:] = 0
    return q, k, v, w, seg


def _jax(dtype, *xs):
    return [jnp.asarray(x).astype(jnp.dtype(dtype)) for x in xs]


def _torch(dtype, *xs):
    return [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]


# L, where row 0 is padded: 100, 200, past a 128-boundary (129, 257), not at all
CASES = [(128, 100), (128, None), (256, 129), (256, 200), (384, 200), (384, 257), (384, None)]


def _plain_forward_matches_jax_kernel(L, pad, dtype, hd=64):
    q, k, v, _, seg = _inputs(L + (pad or 0) + (hd != 64) * hd, L, pad, dtype, hd=hd)
    with interpret_pallas():
        want = jax_flash(*_jax(dtype, q, k, v), segment_ids=SegmentIds(jnp.asarray(seg), jnp.asarray(seg)),
                         sm_scale=SCALE)
    want = torch.from_numpy(np.asarray(want.astype(jnp.float32)))
    s = torch.from_numpy(seg)
    got = fa.flash_forward_ref(*_torch(dtype, q, k, v), s, s, SCALE)[0]
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 2, L, hd)
    if dtype == "float32":
        assert float((got - want).abs().max()) <= 1e-5
    else:
        assert_bf16_close(got, want, "o")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,pad", CASES)
def test_plain_forward_matches_jax_kernel(L, pad, dtype):
    _plain_forward_matches_jax_kernel(L, pad, dtype)


# the other head dims the kernels take: 32 (MiniLM-L12-H384's), 128 (the JAX kernel's multiples of 128),
# 26 (TinyBERT-4L-zh's: on the 32 template, not a multiple of 8) and 96 (on the 128 template)
@pytest.mark.parametrize("hd", [32, 128, 26, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,pad", [(128, 100), (256, 129), (384, 200), (384, None)])
def test_plain_forward_matches_jax_kernel_at_head_dims(L, pad, dtype, hd):
    _plain_forward_matches_jax_kernel(L, pad, dtype, hd)


def _plain_backward_matches_jax_grad(L, pad, dtype, hd=64):
    q, k, v, w, seg = _inputs(7 * L + (pad or 0) + (hd != 64) * hd, L, pad, dtype, hd=hd)
    sj = jnp.asarray(seg)

    def f(q, k, v):
        o = jax_flash(q, k, v, segment_ids=SegmentIds(sj, sj), sm_scale=SCALE)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(w))

    with interpret_pallas():
        want = jax.grad(f, argnums=(0, 1, 2))(*_jax(dtype, q, k, v))
    qt, kt, vt = _torch(dtype, q, k, v)
    s = torch.from_numpy(seg)
    o, l, m = fa.flash_forward_ref(qt, kt, vt, s, s, SCALE)
    do = torch.from_numpy(w).to(qt.dtype)  # JAX's cotangent of o: w cast to o's dtype
    got = fa.flash_backward_ref(qt, kt, vt, s, s, SCALE, l, m, do, fa.flash_di(o, do))
    for name, g, wj in zip(("dq", "dk", "dv"), got, want):
        wt = torch.from_numpy(np.asarray(wj.astype(jnp.float32)))
        assert g.dtype == qt.dtype
        if dtype == "float32":
            assert float((g - wt).abs().max()) <= 1e-5 * float(wt.abs().max()), name
        else:
            assert_bf16_close(g, wt, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,pad", [(128, 100), (256, 129), (384, 200), (384, None)])
def test_plain_backward_matches_jax_grad(L, pad, dtype):
    _plain_backward_matches_jax_grad(L, pad, dtype)


@pytest.mark.parametrize("hd", [32, 128, 26, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("L,pad", [(128, 100), (384, 200)])
def test_plain_backward_matches_jax_grad_at_head_dims(L, pad, dtype, hd):
    _plain_backward_matches_jax_grad(L, pad, dtype, hd)


def test_autograd_function_is_the_plain_pair():
    """On CPU tensors the autograd function runs the plain forward and
    backward (same bits), and no kernel launch is counted."""
    q, k, v, w, seg = _inputs(3, 256, 129, "bfloat16")
    qt, kt, vt = (t.requires_grad_() for t in _torch("bfloat16", q, k, v))
    s = torch.from_numpy(seg)
    counters = (fa.fwd_launches, fa.dkv_launches, fa.dq_launches)
    before = [c.value for c in counters]
    o = fa.flash_attention(qt, kt, vt, s, s, SCALE)
    do = torch.from_numpy(w).bfloat16()
    o.backward(do)
    ro, rl, rm = fa.flash_forward_ref(qt.detach(), kt.detach(), vt.detach(), s, s, SCALE)
    want = fa.flash_backward_ref(qt.detach(), kt.detach(), vt.detach(), s, s, SCALE, rl, rm, do, fa.flash_di(ro, do))
    assert torch.equal(o.detach(), ro)
    for g, wt in zip((qt.grad, kt.grad, vt.grad), want):
        assert torch.equal(g, wt)
    assert [c.value for c in counters] == before


@pytest.mark.parametrize("shape,dtype,why", [
    ((2, 12, 384, 32), torch.bfloat16, None),
    ((2, 12, 384, 80), torch.bfloat16, None),
    ((2, 4, 256, 256), torch.float32, "head dim 256"),
    ((2, 12, 384, 26), torch.float16, None),
    ((2, 8, 384, 128), torch.bfloat16, None),
    ((2, 12, 384, 64), torch.float64, "torch.float64"),
    ((2, 12, 200, 64), torch.bfloat16, "lengths 200"),
    ((2, 12, 384, 64), torch.float32, None),
    ((2, 12, 384, 64), torch.bfloat16, None),
    ((3, 16, 128, 64), torch.float16, None),
    ((2, 2, 128, 130), torch.bfloat16, "head dim 130"),
    ((2, 2, 128, 192), torch.float32, "head dim 192"),
    ((2, 12, 384, 26), torch.bfloat16, None),
    ((2, 4, 256, 1), torch.float32, None),
])
def test_kernel_refusal_rule(shape, dtype, why):
    """What the kernels refuse on a CUDA tensor (bf16, fp16 or fp32, hd 1 to
    128, L a multiple of 128; the JAX kernel's 256 and the head dims it
    refuses too, 130 and 192, refused), read from the wrapper's rule; the
    CPU runs any of them."""
    q = torch.zeros(shape, dtype=dtype)
    got = fa.kernel_refusal(q, q, q)
    assert (got is None) if why is None else (why in got)
    seg = torch.ones(shape[0], shape[2], dtype=torch.int32)
    assert fa.flash_attention(q, q, q, seg, seg, SCALE).shape == shape


# ---- the models ----

SMALL = dict(vocab_size=300, hidden_size=128, num_layers=2, num_heads=2, intermediate_size=256,
             max_position_embeddings=160, dim=32, dtype="float32", attention_impl="flash",
             hidden_dropout=0.0, attention_dropout=0.0)
MV = dict(enabled=True, q_view=8, d_view=8)
DOC_L, QUERY_L = 128, 32


def _tpu_rule(cfg, seq_len):
    return cfg.attention_impl == "flash" and seq_len % 128 == 0 and seq_len >= 128


@contextlib.contextmanager
def jax_flash_on_cpu():
    """The JAX encoder's flash path on the CPU: its TPU dispatch rule, the kernels interpreted."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jbert, "_use_flash", _tpu_rule)
        with interpret_pallas():
            yield


def _ids(seed, B, L):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 300, size=(B, L)).astype(np.int32)
    attn = np.ones((B, L), np.int32)
    for b, n in enumerate((L // 2 + 3, L, 21)[:B]):
        attn[b, n:] = 0
    ids[attn == 0] = 0
    return ids, attn


# widths whose head dim is 32 (four heads of 128), 128 (two of 256) and 26 (TinyBERT-4L-zh's twelve heads
# of 312, its intermediate 1200; two of its four layers and SMALL's vocab), beside SMALL's 64
HEAD_DIM_WIDTHS = {32: dict(hidden_size=128, num_heads=4),
                   128: dict(hidden_size=256, num_heads=2, intermediate_size=512),
                   26: dict(hidden_size=312, num_heads=12, intermediate_size=1200)}


def _jax_params(**kw):
    """Retriever parameters from the flax init (through the explicit path:
    the tree is the same), with non-trivial biases and LayerNorm parameters;
    ``kw`` over SMALL's widths."""
    model = FlaxColbert(jcfg.ModelConfig(**{**SMALL, **kw, "attention_impl": "auto"}), jcfg.MultiviewConfig(**MV))
    z = jnp.zeros((1, QUERY_L), jnp.int32)
    params = model.init(jax.random.PRNGKey(5), z, jnp.ones_like(z), z, jnp.ones_like(z))["params"]
    rng = np.random.default_rng(11)
    return jax.tree_util.tree_map(lambda a: np.asarray(a) + rng.normal(0, 0.05, a.shape).astype(np.float32), params)


def _jax_colbert(**kw):
    return FlaxColbert(jcfg.ModelConfig(**{**SMALL, **kw}), jcfg.MultiviewConfig(**MV))


def _port_cfg(**kw):
    return ModelConfig(**{**SMALL, **kw})


def _port_colbert(params, **kw):
    cfg = _port_cfg(**kw)
    m = ColbertModel(cfg, MultiviewConfig(**MV))
    m.load_state_dict(state_dict_from_jax_params(params, cfg))
    return m


def _colbert_with_flash_matches_jax(dtype, **widths):
    params = _jax_params(**widths)
    dids, dattn = _ids(1, 2, DOC_L)
    qids, qattn = _ids(2, 2, QUERY_L)
    jm = _jax_colbert(dtype=dtype, **widths)
    with jax_flash_on_cpu():
        want = [np.asarray(jm.apply({"params": params}, i, a, method=side))
                for i, a, side in ((dids, dattn, jm.doc), (qids, qattn, jm.query))]
    port = _port_colbert(params, dtype=dtype, **widths).eval()
    with torch.no_grad():
        got = [port.doc(torch.from_numpy(dids), torch.from_numpy(dattn)).numpy(),
               port.query(torch.from_numpy(qids), torch.from_numpy(qattn)).numpy()]
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 8, 32)
        if dtype == "float32":
            assert np.abs(g - w).max() < 1e-4
        else:
            cos = (g * w).sum(-1) / (np.linalg.norm(g, axis=-1) * np.linalg.norm(w, axis=-1))
            assert cos.min() > 0.99


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_colbert_with_flash_matches_jax(dtype):
    """Docs at 128 take flash on both sides, queries at 32 the explicit path."""
    _colbert_with_flash_matches_jax(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 128, 26])
def test_colbert_with_flash_matches_jax_at_head_dims(hd, dtype):
    """As test_colbert_with_flash_matches_jax at head dims 32 (hidden 128, 4
    heads), 128 (hidden 256, 2 heads) and 26 (hidden 312, 12 heads: the
    weights carried across by ``state_dict_from_jax_params`` at those
    widths)."""
    _colbert_with_flash_matches_jax(dtype, **HEAD_DIM_WIDTHS[hd])


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_cross_encoder_with_flash_matches_jax(dtype, atol):
    """The CE's pairs at 128 take flash.  bf16: within 1e-2, the size of
    each side's own bf16 rounding at this width (each side's bf16 logits
    differ from its fp32 logits by up to 6.2e-3 on these inputs, and by the
    same amount with the explicit path: flash adds nothing to it)."""
    rng = np.random.default_rng(12)
    params = {"bert": _jax_params()["bert"],
              "linear": {"kernel": rng.normal(0, 0.05, (128, 1)).astype(np.float32),
                         "bias": rng.normal(0, 0.05, (1,)).astype(np.float32)}}
    dids, dattn = _ids(3, 2, DOC_L)
    with jax_flash_on_cpu():
        want = np.asarray(FlaxCE(jcfg.ModelConfig(**{**SMALL, "dtype": dtype})).apply({"params": params}, dids, dattn))
    cfg = _port_cfg(dtype=dtype)
    m = CrossEncoderModel(cfg)
    m.load_state_dict(state_dict_from_jax_params(params, cfg))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(dids), torch.from_numpy(dattn)).numpy()
    assert np.abs(got - want).max() <= atol


def _grads_match(model, want):
    """Each gradient within 1e-4 of its tensor's largest entry; the key
    biases, whose exact gradient is zero (a softmax ignores a constant
    added to every logit of a row), within 1e-5 of the largest gradient."""
    sd = state_dict_from_jax_params(want, model.cfg)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads.keys() == sd.keys()
    top = max(float(g.abs().max()) for g in sd.values())
    for k, g in grads.items():
        assert g is not None, k
        limit = 1e-5 * top if k.endswith("attention.key.bias") else 1e-4 * float(sd[k].abs().max())
        assert float((g - sd[k]).abs().max()) <= limit, k


def _train_step_gradients_with_flash_match_jax(**widths):
    params = _jax_params(**widths)
    dids, dattn = _ids(1, 2, DOC_L)
    qids, qattn = _ids(2, 2, QUERY_L)
    jm = _jax_colbert(**widths)

    def loss(p):
        d = jm.apply({"params": p}, dids, dattn, method=jm.doc)
        q = jm.apply({"params": p}, qids, qattn, method=jm.query)
        return jnp.einsum("qmh,dnh->qdmn", q, d).max(-1).sum() + (d * d[:, :1]).sum()

    with jax_flash_on_cpu():
        want = jax.grad(loss)(params)
    m = _port_colbert(params, **widths).train()
    d = m.doc(torch.from_numpy(dids), torch.from_numpy(dattn))
    q = m.query(torch.from_numpy(qids), torch.from_numpy(qattn))
    (torch.einsum("qmh,dnh->qdmn", q, d).amax(-1).sum() + (d * d[:, :1]).sum()).backward()
    _grads_match(m, want)


def test_train_step_gradients_with_flash_match_jax():
    """One deterministic step (dropout 0) through flash docs and explicit
    queries: every parameter's gradient against ``jax.grad``."""
    _train_step_gradients_with_flash_match_jax()


@pytest.mark.parametrize("hd", [32, 128, 26])
def test_train_step_gradients_with_flash_match_jax_at_head_dims(hd):
    """As test_train_step_gradients_with_flash_match_jax at head dims 32, 128 and 26."""
    _train_step_gradients_with_flash_match_jax(**HEAD_DIM_WIDTHS[hd])


def test_remat_attn_matches_jax_remat_attn():
    """remat="attn" on the explicit path at 128 against the JAX model's."""
    params = _jax_params()
    dids, dattn = _ids(1, 2, DOC_L)
    jm = _jax_colbert(attention_impl="auto", remat="attn")
    want = jax.grad(lambda p: jm.apply({"params": p}, dids, dattn, method=jm.doc).sum())(params)
    m = _port_colbert(params, attention_impl="auto", remat="attn").train()
    m.doc(torch.from_numpy(dids), torch.from_numpy(dattn)).sum().backward()
    _grads_match(m, want)


# ---- dispatch ----

def _count_flash(monkeypatch):
    calls = []
    real = fa.flash_forward_ref
    monkeypatch.setattr(fa, "flash_forward_ref", lambda *a: calls.append(a[0].shape) or real(*a))
    return calls


def test_flash_only_at_multiples_of_128(monkeypatch):
    """The JAX rule: a query at 32 takes the explicit path, docs at 128 and 384 flash."""
    calls = _count_flash(monkeypatch)
    m = ColbertModel(_port_cfg(max_position_embeddings=384), MultiviewConfig(**MV)).eval()
    m.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for L in (32, 128, 384):
            ids, attn = _ids(L, 2, L)
            m.doc(torch.from_numpy(ids), torch.from_numpy(attn))
    assert calls == [(2, 2, 128, 64)] * 2 + [(2, 2, 384, 64)] * 2
    assert not tbert.use_flash(_port_cfg(attention_impl="auto"), 384)
    assert not tbert.use_flash(_port_cfg(), 200)


@pytest.mark.parametrize("impl", ["flash", "auto"])
def test_attention_dropout_site_under_flash(monkeypatch, impl):
    """Under flash the attention dropout acts on the attention output (B, L,
    h), though ``attention_dropout_site`` says "probs"; the explicit path
    drops the (B, nh, L, L) probabilities."""
    shapes = []
    real = tbert.hw_dropout
    monkeypatch.setattr(tbert, "hw_dropout", lambda x, seed, thr: shapes.append(tuple(x.shape)) or real(x, seed, thr))
    cfg = _port_cfg(attention_impl=impl, hidden_dropout=0.1, attention_dropout=0.1, attention_dropout_site="probs")
    m = ColbertModel(cfg, MultiviewConfig(**MV)).train()
    m.init_weights(torch.Generator().manual_seed(0))
    ids, attn = _ids(4, 2, DOC_L)
    m.doc(torch.from_numpy(ids), torch.from_numpy(attn), generator=torch.Generator().manual_seed(1))
    hidden = (2, DOC_L, 128)
    attn_site = hidden if impl == "flash" else (2, 2, DOC_L, DOC_L)
    assert shapes == [hidden] + [attn_site, hidden, hidden] * 2


# ---- remat ----

def _step_grads(cfg):
    m = ColbertModel(cfg, MultiviewConfig(**MV)).train()
    m.init_weights(torch.Generator().manual_seed(2))
    ids, attn = _ids(9, 3, DOC_L)
    d = m.doc(torch.from_numpy(ids), torch.from_numpy(attn), generator=torch.Generator().manual_seed(3))
    d.sum().backward()
    return d.detach(), {k: p.grad for k, p in m.named_parameters()}


@pytest.mark.parametrize("impl", ["flash", "auto"])
@pytest.mark.parametrize("remat", ["full", "dots", "attn"])
def test_remat_gradients_bit_equal(impl, remat):
    """Remat is a scheduling change: with dropout 0.1 (K9's plain version)
    and a seeded generator, the outputs and every gradient equal no remat's
    bit for bit (each layer's seeds are drawn before the layer runs)."""
    cfg = _port_cfg(attention_impl=impl, hidden_dropout=0.1, attention_dropout=0.1)
    o0, g0 = _step_grads(cfg)
    o1, g1 = _step_grads(dataclasses.replace(cfg, remat=remat))
    assert torch.equal(o0, o1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


@pytest.mark.parametrize("remat,per_layer", [("none", 1), ("full", 2), ("dots", 2), ("attn", 1)])
def test_remat_recomputes_flash(monkeypatch, remat, per_layer):
    """Under "full" and "dots" the backward recomputes each layer's flash
    forward (K11 launches twice a layer on the card); "attn" tags nothing on
    the flash path, so it saves everything, as "none" does."""
    calls = _count_flash(monkeypatch)
    _step_grads(_port_cfg(hidden_dropout=0.1, attention_dropout=0.1, remat=remat))
    assert len(calls) == per_layer * SMALL["num_layers"]

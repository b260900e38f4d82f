"""The port's BERT + ColBERT head against the Flax model, and checkpoint conversion.

Both models get the same parameters (the Flax init, converted with
``state_dict_from_jax_params``) and the same seeded token ids.
Tolerances: at fp32 the two differ only by operation order (max |delta| <
1e-4); at bf16 they round at different places, so the check is per-token
cosine > 0.99.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.config import ModelConfig, MultiviewConfig
from colbert_tpu.models import ColbertModel as FlaxColbert
from colbert_tpu.models.convert import colbert_params_to_torch_state_dict
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.convert import (
    reference_state_dict, state_dict_from_jax_params, state_dict_from_reference,
)

CFG = ModelConfig(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
                  intermediate_size=128, max_position_embeddings=64, dim=32, dtype="float32")
MV = MultiviewConfig(enabled=True, q_view=8, d_view=8)


def _inputs(seed, B, L):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG.vocab_size, size=(B, L)).astype(np.int32)
    attn = np.ones((B, L), np.int32)
    for b in range(B):
        attn[b, rng.integers(L // 2, L + 1):] = 0
    ids[attn == 0] = 0
    return ids, attn


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxColbert(CFG, MV)
    ids = jnp.zeros((1, 16), jnp.int32)
    params = model.init(jax.random.PRNGKey(3), ids, jnp.ones_like(ids), ids, jnp.ones_like(ids))["params"]
    # non-trivial LayerNorm and bias parameters, so the conversion of each is checked
    rng = np.random.default_rng(11)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, size=a.shape).astype(np.float32), params
    )


def _port(params, cfg):
    m = ColbertModel(cfg, MV)
    m.load_state_dict(state_dict_from_jax_params(params, cfg))
    return m.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side,L", [("query", 16), ("doc", 24)])
def test_colbert_matches_flax(flax_params, dtype, side, L):
    cfg = dataclasses.replace(CFG, dtype=dtype)
    ids, attn = _inputs(5, 3, L)
    fm = FlaxColbert(cfg, MV)
    want = np.asarray(
        fm.apply({"params": flax_params}, jnp.asarray(ids), jnp.asarray(attn), method=getattr(fm, side))
    )
    with torch.no_grad():
        got = getattr(_port(flax_params, cfg), side)(torch.from_numpy(ids), torch.from_numpy(attn)).numpy()
    assert got.shape == want.shape == (3, 8, 32) and got.dtype == np.float32
    if dtype == "float32":
        assert np.abs(got - want).max() < 1e-4
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() > 0.99


def test_reference_checkpoint_round_trip(flax_params, tmp_path):
    """JAX params -> reference pytorch.bin -> port: the same weights and outputs."""
    ref_sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in colbert_params_to_torch_state_dict(flax_params, CFG).items()}
    path = tmp_path / "pytorch.bin"
    torch.save(ref_sd, path)
    from_ref = state_dict_from_reference(str(path), CFG)
    from_jax = state_dict_from_jax_params(flax_params, CFG)
    assert from_ref.keys() == from_jax.keys() == ColbertModel(CFG, MV).state_dict().keys()
    for k in from_jax:
        torch.testing.assert_close(from_ref[k], from_jax[k], rtol=0, atol=0)
    # and back: the port writes the layout it reads
    back = reference_state_dict(from_ref, CFG)
    assert back.keys() == ref_sd.keys()
    for k in back:
        torch.testing.assert_close(back[k], ref_sd[k], rtol=0, atol=0)


def test_reference_loader_names_missing_keys():
    with pytest.raises(KeyError, match="colbert_params_to_torch_state_dict"):
        state_dict_from_reference({"linear.weight": torch.zeros(32, 64)}, CFG)


def test_seeded_init_is_reproducible():
    a, b = ColbertModel(CFG, MV), ColbertModel(CFG, MV)
    a.init_weights(torch.Generator().manual_seed(0))
    b.init_weights(torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert float(a.bert.layers[0].attention.query.weight.detach().std()) == pytest.approx(0.02, rel=0.1)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("side,L", [("query", 16), ("doc", 24)])
def test_compute_softmax_dtype_matches_flax(flax_params, dtype, side, L):
    """``attention_softmax_dtype="compute"``: logits, scale, bias and softmax
    in the compute dtype on both sides.  At bf16 the dense layers round at
    different places (per-token cosine > 0.99, the bf16 limit above; the
    softmax alone is held closer by the next test); at fp32 it is the fp32
    path (max |delta| < 1e-4)."""
    cfg = dataclasses.replace(CFG, dtype=dtype, attention_softmax_dtype="compute")
    ids, attn = _inputs(6, 3, L)
    fm = FlaxColbert(cfg, MV)
    want = np.asarray(
        fm.apply({"params": flax_params}, jnp.asarray(ids), jnp.asarray(attn), method=getattr(fm, side))
    )
    with torch.no_grad():
        got = getattr(_port(flax_params, cfg), side)(torch.from_numpy(ids), torch.from_numpy(attn)).numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() < 1e-4
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() > 0.99
        with torch.no_grad():  # and it is not the fp32-softmax computation
            fp32 = _port(flax_params, dataclasses.replace(cfg, attention_softmax_dtype="fp32"))
            assert not np.array_equal(getattr(fp32, side)(torch.from_numpy(ids), torch.from_numpy(attn)).numpy(), got)


@pytest.mark.parametrize("softmax_dtype", ["compute", "fp32"])
def test_attention_softmax_rounds_as_flax(softmax_dtype):
    """One bf16 attention layer with identity projections and zero biases,
    so its output is softmax(q k^T / sqrt(hd) + bias) v and the dense layers
    add no rounding of their own: the port's softmax path must round where
    flax's does.  Per element within one bf16 ulp of flax's same path, and
    on average ten times closer to it than to flax's other path."""
    from colbert_tpu.models.bert import BertSelfAttention as FlaxAttention
    from colbert_tpu_torch.models.bert import BertSelfAttention

    cfg = dataclasses.replace(CFG, dtype="bfloat16", attention_softmax_dtype=softmax_dtype)
    other = dataclasses.replace(cfg, attention_softmax_dtype="fp32" if softmax_dtype == "compute" else "compute")
    rng = np.random.default_rng(7)
    _, attn = _inputs(8, 3, 24)
    x = torch.from_numpy(rng.normal(0, 1.5, (3, 24, CFG.hidden_size)).astype(np.float32)).bfloat16()
    bias = (1.0 - attn[:, None, None, :].astype(np.float32)) * -1e9
    h = CFG.hidden_size
    dense = {"kernel": np.eye(h, dtype=np.float32), "bias": np.zeros(h, np.float32)}
    params = {name: dense for name in ("query", "key", "value", "out")}
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    def flax(c):
        out = FlaxAttention(c).apply({"params": params}, xj, jnp.asarray(bias), jnp.asarray(attn), True)
        return np.asarray(out.astype(jnp.float32))

    want, want_other = flax(cfg), flax(other)
    port = BertSelfAttention(cfg).eval()
    port.load_state_dict({f"{n}.{k}": torch.eye(h) if k == "weight" else torch.zeros(h)
                          for n in params for k in ("weight", "bias")})
    with torch.no_grad():
        got = port(x, torch.from_numpy(bias)).float().numpy()
    err = np.abs(got - want)
    assert (err <= np.abs(want) * 2.0**-8).all()
    assert err.mean() < np.abs(got - want_other).mean() / 10


@pytest.mark.parametrize("rows,dtype", [(2, torch.bfloat16), (300, torch.float32)])
def test_lookup_is_the_embedding(rows, dtype):
    """``models.bert.lookup``, which the embeddings take for word ids and
    token types: ``F.embedding``'s values and, on CPU tensors, its gradient
    bit for bit, ids repeated many times; the deterministic-algorithms
    setting left as it was."""
    from colbert_tpu_torch.models.bert import lookup

    g = torch.Generator().manual_seed(rows)
    ids = torch.randint(0, min(rows, 7), (6, 40), generator=g)
    w = torch.randn((rows, 16), generator=g).to(dtype)
    up = torch.randn((6, 40, 16), generator=g).to(dtype)
    a, b = w.clone().requires_grad_(), w.clone().requires_grad_()
    before = torch.are_deterministic_algorithms_enabled()
    out = lookup(ids, a)
    out.backward(up)
    want = torch.nn.functional.embedding(ids, b)
    want.backward(up)
    assert torch.equal(out, want) and torch.equal(a.grad, b.grad)
    assert torch.are_deterministic_algorithms_enabled() == before


@pytest.mark.parametrize("rows,n,span,dtype", [
    (2, 26_112, 1, torch.bfloat16),      # token types at the doc pass: one id, every row
    (2, 600, 2, torch.float32),
    (300, 240, 7, torch.float32),        # a few ids repeated many times
    (21_128, 6_000, 2_001, torch.bfloat16),  # the word table, a padding id on half the rows
])
def test_lookup_backward_sums_like_the_embedding(rows, n, span, dtype):
    """``models.bert.lookup_backward``, the lookup's backward on the card (the
    one-hot product up to ``ONE_HOT_ROWS`` rows, the sorted two-level sum
    above), run on CPU tensors: ``F.embedding``'s gradient in fp32 rounded
    once to the dtype (its CUDA backward's accumulation; the CPU one sums
    bf16 in bf16) bit for bit where every fp32 sum is exact (quarter
    integers), and within fp32 rounding of the float64 sums (N * 2^-24 of
    the sum of magnitudes, then one rounding to the dtype) on random values."""
    from colbert_tpu_torch.models import bert

    g = torch.Generator().manual_seed(rows + n)
    ids = torch.randint(0, span, (n,), generator=g)
    ids[: n // 2] = 0
    exact = (torch.randint(-8, 9, (n, 16), generator=g).float() / 4).to(dtype)
    w = torch.zeros((rows, 16), requires_grad=True)
    torch.nn.functional.embedding(ids, w).backward(exact.float())
    assert torch.equal(bert.lookup_backward(ids, exact, rows), w.grad.to(dtype))
    up = torch.randn((n, 16), generator=g).to(dtype)
    want = torch.zeros((rows, 16), dtype=torch.float64).index_add_(0, ids, up.double())
    mags = torch.zeros((rows, 16), dtype=torch.float64).index_add_(0, ids, up.double().abs())
    got = bert.lookup_backward(ids.view(2, -1), up.view(2, -1, 16), rows)  # batch-shaped, as the model's (B, L)
    assert got.dtype == dtype and got.shape == (rows, 16)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -23
    assert bool(((got.double() - want).abs() <= n * 2.0 ** -24 * mags + ulp * want.abs()).all())
    for form in (bert.one_hot_sum, bert.sorted_sum):  # both forms, the same exact sums
        if form is bert.sorted_sum or rows <= 512:
            assert torch.equal(form(ids, exact, rows), w.grad)


def test_lookup_backward_leaves_the_deterministic_flag_alone(monkeypatch):
    """No backward through the embeddings calls ``torch.use_deterministic_algorithms``
    (a process-wide flag: other threads' ops would run under it): the lookup's
    backward on CPU tensors and its card form run on CPU tensors, with the
    flag's setter patched to raise."""
    from colbert_tpu_torch.models import bert

    def refuse(*a, **kw):
        raise AssertionError("torch.use_deterministic_algorithms called")
    monkeypatch.setattr(torch, "use_deterministic_algorithms", refuse)
    emb = bert.BertEmbeddings(CFG).train()
    g = torch.Generator().manual_seed(5)
    ids = torch.randint(0, CFG.vocab_size, (3, 24), generator=g)
    emb(ids, torch.zeros_like(ids), torch.float32, generator=torch.Generator().manual_seed(1)).sum().backward()
    assert emb.word_embeddings.weight.grad is not None and emb.token_type_embeddings.weight.grad is not None
    up = torch.randn((72, 8), generator=g)
    for rows in (2, 300):
        bert.lookup_backward(ids.reshape(-1) % rows, up, rows)


# ---- model.fused_qkv and model.embedding_impl="onehot" ----

def _doc_loss_grads(params, cfg, ids, attn, w):
    """Flax: the doc output and the gradient tree of sum(doc * w)."""
    fm = FlaxColbert(cfg, MV)

    def loss(p):
        d = fm.apply({"params": p}, jnp.asarray(ids), jnp.asarray(attn), method=fm.doc)
        return (d * jnp.asarray(w)).sum(), d
    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(out), grads


def _port_doc_grads(params, cfg, ids, attn, w, **kw):
    m = _port(params, cfg)
    out = m.doc(torch.from_numpy(ids), torch.from_numpy(attn))
    (out * torch.from_numpy(w)).sum().backward()
    return m, out.detach().numpy()


def _grads_within(model, want, cfg, rel=1e-4):
    """Each port gradient within ``rel`` of its tensor's largest entry of the
    flax gradient (converted as parameters are); the key biases, whose exact
    gradient is zero, within ``rel / 10`` of the largest gradient."""
    sd = state_dict_from_jax_params(want, cfg)
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert grads.keys() == sd.keys()
    top = max(float(g.abs().max()) for g in sd.values())
    for k, g in grads.items():
        limit = rel / 10 * top if k.endswith("attention.key.bias") else rel * float(sd[k].abs().max())
        assert g is not None and float((g - sd[k]).abs().max()) <= limit, k


def test_fused_qkv_matches_flax_fused_qkv(flax_params):
    """fp32, ``fused_qkv=True`` on both sides: the doc output within 1e-4 of
    flax's and every gradient within 1e-4 of its tensor's largest entry;
    the parameters and state dict those of the unfused model (checkpoints
    and ``models/convert.py`` unchanged)."""
    cfg = dataclasses.replace(CFG, fused_qkv=True)
    ids, attn = _inputs(21, 3, 24)
    w = np.random.default_rng(22).normal(size=(3, 8, 32)).astype(np.float32)
    want, want_grads = _doc_loss_grads(flax_params, cfg, ids, attn, w)
    m, got = _port_doc_grads(flax_params, cfg, ids, attn, w)
    assert np.abs(got - want).max() < 1e-4
    _grads_within(m, want_grads, cfg)
    plain = ColbertModel(CFG, MV).state_dict()
    assert {k: v.shape for k, v in m.state_dict().items()} == {k: v.shape for k, v in plain.items()}
    assert reference_state_dict(m.state_dict(), cfg).keys() == reference_state_dict(plain, CFG).keys()


def test_fused_qkv_is_one_product(flax_params):
    """With the option on, a layer's q, k and v come from one (H, 3H) GEMM
    (two fewer GEMMs a layer than without), split as flax splits it: q then
    k then v.  bf16 outputs against flax's fused model at the bf16 limit
    (per-token cosine > 0.99)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
            return func(*args, **(kwargs or {}))

    ids, attn = _inputs(23, 2, 24)
    counts = {}
    for fused in (False, True):
        m = _port(flax_params, dataclasses.replace(CFG, fused_qkv=fused))
        with torch.no_grad(), Count() as c:
            m.doc(torch.from_numpy(ids), torch.from_numpy(attn))
        counts[fused] = c.n
    assert counts[False] - counts[True] == 2 * CFG.num_layers
    cfg = dataclasses.replace(CFG, dtype="bfloat16", fused_qkv=True)
    fm = FlaxColbert(cfg, MV)
    want = np.asarray(fm.apply({"params": flax_params}, jnp.asarray(ids), jnp.asarray(attn), method=fm.doc))
    with torch.no_grad():
        got = _port(flax_params, cfg).doc(torch.from_numpy(ids), torch.from_numpy(attn)).numpy()
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    assert cos.min() > 0.99


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_onehot_embeddings_forward_is_the_lookup(flax_params, dtype):
    """``embedding_impl="onehot"``: the embeddings' output and the model's
    doc output bit-equal to ``"take"``'s in the port (each output one
    product by 1 plus zeros)."""
    ids, attn = _inputs(24, 3, 24)
    name = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]
    take = _port(flax_params, dataclasses.replace(CFG, dtype=name))
    onehot = _port(flax_params, dataclasses.replace(CFG, dtype=name, embedding_impl="onehot"))
    i, a = torch.from_numpy(ids).long(), torch.from_numpy(attn)
    with torch.no_grad():
        e_take = take.bert.embeddings(i, torch.zeros_like(i), dtype)
        e_onehot = onehot.bert.embeddings(i, torch.zeros_like(i), dtype)
        assert e_take.dtype == dtype and torch.equal(e_take, e_onehot)
        assert torch.equal(take.doc(i, a), onehot.doc(i, a))


def test_onehot_word_gradient_matches_flax_onehot(flax_params):
    """fp32: every gradient of the model with ``embedding_impl="onehot"``
    against flax's with the same option (1e-4 of each tensor's largest)."""
    cfg = dataclasses.replace(CFG, embedding_impl="onehot")
    ids, attn = _inputs(25, 3, 24)
    w = np.random.default_rng(26).normal(size=(3, 8, 32)).astype(np.float32)
    want, want_grads = _doc_loss_grads(flax_params, cfg, ids, attn, w)
    m, got = _port_doc_grads(flax_params, cfg, ids, attn, w)
    assert np.abs(got - want).max() < 1e-4
    _grads_within(m, want_grads, cfg)


def test_onehot_word_gradient_rounds_as_jax():
    """bf16: the word table's gradient is the one-hot product in bf16, then
    a cast to fp32, as JAX's ``(one_hot(ids) @ table.astype(bf16))`` gives it
    (``jax.vjp`` with the same bf16 cotangent): within one bf16 ulp of JAX's,
    ids repeated ~7 times each."""
    from colbert_tpu_torch.models.bert import onehot_lookup

    rng = np.random.default_rng(27)
    ids = rng.integers(0, 20, (6, 24)).astype(np.int32)
    table = rng.normal(0, 0.02, (20, 16)).astype(np.float32)
    up = rng.normal(0, 1, (6, 24, 16)).astype(np.float32)

    def jax_fn(t):
        return jax.nn.one_hot(jnp.asarray(ids), 20, dtype=jnp.bfloat16) @ t.astype(jnp.bfloat16)
    out_j, vjp = jax.vjp(jax_fn, jnp.asarray(table))
    (want,) = vjp(jnp.asarray(up).astype(jnp.bfloat16))
    w = torch.from_numpy(table).requires_grad_()
    out = onehot_lookup(torch.from_numpy(ids).long(), w.to(torch.bfloat16))
    out.backward(torch.from_numpy(up).bfloat16())
    assert torch.equal(out.float(), torch.from_numpy(np.array(out_j.astype(jnp.float32))))
    want = np.asarray(want)
    got = w.grad.numpy()
    assert w.grad.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got, got.astype(jnp.bfloat16).astype(np.float32))  # rounded to bf16 once
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("remat", ["full", "dots", "attn"])
def test_fused_qkv_and_onehot_under_remat(flax_params, remat):
    """Both options on: every remat policy gives the loss and gradients of
    the same step without remat, bit for bit (CPU)."""
    ids, attn = _inputs(28, 3, 24)
    w = torch.from_numpy(np.random.default_rng(29).normal(size=(3, 8, 32)).astype(np.float32))
    runs = []
    for policy in ("none", remat):
        cfg = dataclasses.replace(CFG, fused_qkv=True, embedding_impl="onehot", remat=policy)
        m = _port(flax_params, cfg)
        loss = (m.doc(torch.from_numpy(ids), torch.from_numpy(attn)) * w).sum()
        loss.backward()
        runs.append((loss.detach(), {k: p.grad for k, p in m.named_parameters()}))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(runs[0][1][k], runs[1][1][k]) for k in runs[0][1])

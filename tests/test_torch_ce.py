"""The port's cross-encoder (model, pairs, trainer, rerank, checkpoints)
against the JAX package, on the CPU, at a tiny size (2 layers, hidden 32).

Limits:

* ``listnet_loss`` and ``kl_loss``: within 1e-6 (fp32, two summation orders);
* ``encode_ce_pairs``: ids and masks identical (truncation past
  ``ce_maxlen``, Chinese punctuation, ``[SEP]`` inside a passage);
* the CE forward from the same (converted) parameters: within 1e-5 at fp32;
  at bf16 within 4e-3, 4 bf16 ulps at the logits' magnitude (~0.23): both
  sides round every matmul, LayerNorm and GELU output to bf16, and a
  rounding that flips early moves the readout by an ulp or two;
* ``_build_pairs``: identical arrays in the train, dev, test and distill
  modes (the same numpy draws), and the same errors;
* three train steps with dropout rates 0 (accum 1, accum 2, distill), at
  the reference's CE learning rate 1e-5: loss within 1e-5, every gradient
  within 1e-4 of its tensor's largest entry of the JAX loss's gradient,
  and every parameter within 1e-6 of the JAX ``CETrainer``'s jitted step
  after each update (both fp32; only the operation order differs), but the
  parameters whose gradient is exactly zero (the key biases, the last
  LayerNorm's bias and the head's bias: held at 1e-5 of the largest
  gradient instead), since the CE's optimizer takes Adam's default eps
  (1e-8), which scales each side's rounding noise up to ~lr a step;
* dev MRR equal, and the ``rerank`` order equal, on the same parameters;
* the JAX ``ce_params_from_torch`` reads the port's CE checkpoint: logits
  within 1e-5;
* resume: a run resumed from its step-2 checkpoint is bit-equal to the
  straight run.
"""

import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import colbert_tpu.config as jcfg
import colbert_tpu_torch.config as tcfg
from colbert_tpu_torch.models.convert import state_dict_from_jax_params

# two intra-op threads a worker: the suite runs in several workers beside JAX's thread pools
torch.set_num_threads(2)

WORDS = ["apple", "river", "mountain", "piano", "dragon", "silver", "ocean", "candle", "forest", "marble"]
CHINESE = ["长江是中国最长的河流。", "北京，中国的首都！", "故宫位于北京市中心；", "《红楼梦》是一部小说？"]


def make_examples(n, seed=0, n_neg=(2, 9)):
    """Synthetic CE data: the positive repeats the question's word; a varying
    number of hard negatives (some fewer than the pools, so padding runs)."""
    rng = np.random.default_rng(seed)
    exs = []
    for i in range(n):
        w = WORDS[i % len(WORDS)]
        others = [x for x in WORDS if x != w]
        exs.append({
            "question": f"find {w} " + "very " * int(rng.integers(0, 3)),
            "positive_ctxs": [f"{w} {w} text about {w}" + " more" * int(rng.integers(0, 8)),
                              f"{w} again"][: int(rng.integers(1, 3))],
            "hard_negative_ctxs": [f"{o} stuff {o}" + " x" * int(rng.integers(0, 12))
                                   for o in rng.permutation(others)][: int(rng.integers(*n_neg))],
        })
    return exs


def make_cfg(tmp_path, dtype="float32", **ce_kw):
    from colbert_tpu_torch.tokenization import build_vocab, write_vocab

    vp = write_vocab(build_vocab([" ".join(WORDS), "find text about stuff very more again x"] + CHINESE),
                     tmp_path / "vocab.txt")
    model = dict(vocab_size=256, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                 max_position_embeddings=64, dim=16, dtype=dtype)
    ce = dict(learning_rate=1e-3, per_device_batch_size=2, num_epochs=1, neg_num=2, neg_pool_lo=1,
              neg_pool_hi=5, eval_topk=6, distill_group=4, log_every=1, seed=3,
              checkpoint_dir=str(tmp_path / "ce_ckpt"))
    ce.update(ce_kw)
    return tcfg.ColbertConfig(
        model=tcfg.ModelConfig(**model),
        ce_model=tcfg.ModelConfig(**model),
        multiview=tcfg.MultiviewConfig(enabled=True, q_view=4, d_view=4),
        tokenizer=tcfg.TokenizerConfig(vocab_path=vp, query_maxlen=12, doc_maxlen=24, ce_maxlen=24),
        train=tcfg.TrainConfig(checkpoint_dir=str(tmp_path / "ckpt")),
        ce_train=tcfg.CETrainConfig(**ce),
        index=tcfg.IndexConfig(pq_m=4, index_path=str(tmp_path / "index"), num_parts=2),
        serve=tcfg.ServeConfig(mode="flat", topk=5, query_batch_size=4),
    )


def to_jax_cfg(cfg):
    return jcfg.ColbertConfig.from_dict(cfg.to_dict())


def no_dropout(cfg):
    return dataclasses.replace(cfg, ce_model=dataclasses.replace(cfg.ce_model, hidden_dropout=0.0,
                                                                 attention_dropout=0.0))


def with_ce(cfg, **kw):
    return dataclasses.replace(cfg, ce_train=dataclasses.replace(cfg.ce_train, **kw))


def distill_examples(n, seed=0):
    """``gen_distill_data``-shaped examples; some windows shorter than the group."""
    rng = np.random.default_rng(seed)
    out = []
    for ex in make_examples(n, seed):
        win = [ex["positive_ctxs"][0]] + ex["hard_negative_ctxs"]
        k = int(rng.integers(1, 6))
        out.append({"question": ex["question"], "positive_ctxs": [win[0]],
                    "res_scored": [[float(s), x] for s, x in zip(np.sort(rng.normal(size=k))[::-1], win)]})
    return out


def test_examples_cover_the_padding_paths():
    exs = make_examples(12)
    assert min(len(e["hard_negative_ctxs"]) for e in exs) < 4 < max(len(e["hard_negative_ctxs"]) for e in exs)
    assert min(len(e["res_scored"]) for e in distill_examples(12)) < 4


def jax_tokenizer(cfg):
    from colbert_tpu.tokenization import ColbertTokenizer as JaxTokenizer

    jc = to_jax_cfg(cfg)
    return JaxTokenizer(jc.tokenizer, jc.multiview)


def port_tokenizer(cfg):
    from colbert_tpu_torch.tokenization import ColbertTokenizer

    return ColbertTokenizer(cfg.tokenizer, cfg.multiview)


# ---- losses ----

@pytest.mark.parametrize("name", ["listnet_loss", "kl_loss"])
def test_distill_losses_equal_jax(name):
    from colbert_tpu.training import losses as jl
    from colbert_tpu_torch.training import losses as tl

    rng = np.random.default_rng(2)
    pred = rng.normal(size=(5, 8)).astype(np.float32) * 3
    true = rng.normal(size=(5, 8)).astype(np.float32) * 3
    true[0, 5:] = -1e4  # the teacher's padding slots
    want = float(getattr(jl, name)(jnp.asarray(pred), jnp.asarray(true)))
    got = float(getattr(tl, name)(torch.from_numpy(pred), torch.from_numpy(true)))
    assert got == pytest.approx(want, abs=1e-6)


def test_kl_loss_divides_by_rows():
    from colbert_tpu_torch.training.losses import kl_loss

    pred, true = torch.zeros(4, 3), torch.tensor([[1.0, 0.0, 0.0]] * 4)
    one = kl_loss(pred[:1], true[:1])
    assert float(kl_loss(pred, true)) == pytest.approx(float(one), rel=1e-6)


# ---- pairs ----

def test_encode_ce_pairs_equal_jax(tmp_path):
    cfg = make_cfg(tmp_path)
    long_passage = "".join(CHINESE) * 3 + " apple river"
    pairs = [
        ("find apple", "apple apple text"),
        ("长江是什么？", long_passage),                      # cut past ce_maxlen: no final [SEP]
        ("北京，首都！", "故宫[SEP]位于北京市中心；"),          # [SEP] inside a passage
        ("", ""),
        ("find river " * 6, "river stuff"),                   # a question longer than ce_maxlen
        ("《红楼梦》", "“引号”…—（全角）、。"),
    ]
    want, got = jax_tokenizer(cfg).encode_ce_pairs(pairs), port_tokenizer(cfg).encode_ce_pairs(pairs)
    for name in ("input_ids", "attention_mask"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == np.int32 and a.shape == b.shape == (len(pairs), 24), name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.attention_mask[1].all() and got.input_ids[1, -1] != port_tokenizer(cfg).tok.vocab["[SEP]"]


def _trainers(cfg, jax_init=None, port_init=None):
    from colbert_tpu.parallel import make_mesh
    from colbert_tpu.training import CETrainer as JaxCE
    from colbert_tpu_torch.training import CETrainer

    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    j = JaxCE(to_jax_cfg(cfg), jax_tokenizer(cfg), mesh=mesh, init_params=jax_init)
    t = CETrainer(cfg, port_tokenizer(cfg), device="cpu", init_state_dict=port_init)
    return j, t


@pytest.mark.parametrize("mode", ["train", "dev", "test", "distill"])
def test_build_pairs_identical(tmp_path, mode):
    cfg = make_cfg(tmp_path)
    j, t = _trainers(cfg)
    if mode == "distill":
        exs = distill_examples(6)
    elif mode == "test":
        exs = [{"question": e["question"], "retrieval_res": e["hard_negative_ctxs"] * 2} for e in make_examples(6)]
    else:
        exs = make_examples(6)
    for step in range(3):
        j.np_rng = np.random.default_rng((cfg.ce_train.seed, step))
        t.np_rng = np.random.default_rng((cfg.ce_train.seed, step))
        want, got = j._build_pairs(exs, mode), t._build_pairs(exs, mode)
        assert got[2] == want[2]
        for a, b in zip((got[0], got[1]), (want[0], want[1])):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        if mode == "distill":
            np.testing.assert_array_equal(got[3], want[3])
            assert (got[3] == np.float32(-1e4)).any()
        else:
            assert got[3] is None and want[3] is None


@pytest.mark.parametrize("mode,bad,match", [
    ("train", {"question": "q-no-negs", "positive_ctxs": ["p"], "hard_negative_ctxs": []}, "q-no-negs"),
    ("distill", {"question": "q-empty", "positive_ctxs": ["p"], "res_scored": []}, "q-empty"),
])
def test_build_pairs_errors_name_the_question(tmp_path, mode, bad, match):
    j, t = _trainers(make_cfg(tmp_path))
    with pytest.raises(ValueError) as want:
        j._build_pairs([bad], mode)
    with pytest.raises(ValueError, match=match) as got:
        t._build_pairs([bad], mode)
    assert str(got.value) == str(want.value)


# ---- the model ----

def _flax_ce_params(cfg, seed=7, noise=0.05):
    from colbert_tpu.models import CrossEncoderModel as FlaxCE

    model = FlaxCE(to_jax_cfg(cfg).ce_model)
    z = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(seed), z, jnp.ones_like(z))["params"]
    rng = np.random.default_rng(seed)  # non-trivial LayerNorm, bias and head parameters
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, noise, size=a.shape).astype(np.float32), params)


def _pair_batch(cfg, n=6):
    tok = port_tokenizer(cfg)
    exs = make_examples(n, seed=5)
    return tok.encode_ce_pairs([(e["question"], c) for e in exs for c in e["hard_negative_ctxs"][:2]])


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5), ("bfloat16", 4e-3)])
def test_ce_forward_equal_jax(tmp_path, dtype, atol):
    from colbert_tpu.models import CrossEncoderModel as FlaxCE
    from colbert_tpu_torch.models.ce import CrossEncoderModel

    cfg = make_cfg(tmp_path, dtype=dtype)
    params = _flax_ce_params(cfg)
    enc = _pair_batch(cfg)
    want = np.asarray(FlaxCE(to_jax_cfg(cfg).ce_model).apply({"params": params}, enc.input_ids, enc.attention_mask))
    m = CrossEncoderModel(cfg.ce_model)
    m.load_state_dict(state_dict_from_jax_params(params, cfg.ce_model))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(enc.input_ids), torch.from_numpy(enc.attention_mask)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (enc.input_ids.shape[0],)
    assert np.abs(want).max() > 0.1  # the logits are not all near zero
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if dtype == "bfloat16":  # the readout runs in the model dtype, then is cast to fp32, as flax's
        for logits in (got, want):
            t = torch.tensor(logits)
            assert torch.equal(t, t.bfloat16().float())


def test_ce_init_is_seeded_with_a_zero_bias(tmp_path):
    from colbert_tpu_torch.models.ce import CrossEncoderModel

    cfg = make_cfg(tmp_path)
    a, b = CrossEncoderModel(cfg.ce_model), CrossEncoderModel(cfg.ce_model)
    a.init_weights(torch.Generator().manual_seed(4))
    b.init_weights(torch.Generator().manual_seed(4))
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name
    assert a.linear.weight.shape == (1, 32) and torch.equal(a.linear.bias, torch.zeros(1))
    assert abs(float(a.linear.weight.detach().std()) - cfg.ce_model.initializer_range) < 0.01


# ---- train steps against the JAX trainer ----

def _jax_flat(params, cfg):
    return {k: v.numpy() for k, v in state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg.ce_model).items()}


def _jax_grad_fn(j, cfg):
    """The gradient of the JAX CE loss at dropout 0 (no accumulation)."""
    from colbert_tpu.training.losses import biencoder_nll_loss, kl_loss

    c = cfg.ce_train

    def loss(params, ids, attn, group, teacher):
        scores = j.model.apply({"params": params}, ids, attn).reshape(-1, group) / c.score_temperature
        nll = biencoder_nll_loss(scores, jnp.zeros((scores.shape[0],), jnp.int32))
        if c.distill_weight <= 0:
            return nll
        return (1 - c.distill_weight) * nll + c.distill_weight * kl_loss(scores, teacher / c.distill_temperature)

    return jax.jit(jax.grad(loss), static_argnums=(3,))


def _zero_gradient(name, cfg):
    """Parameters whose gradient is exactly zero, so both sides hold rounding
    noise only, which Adam (eps 1e-8) scales up to ~lr a step: the key biases
    (each shifts a query's logits by a constant, which the softmax ignores)
    and what adds one constant to every logit of a question's row (the last
    LayerNorm's bias, the head's bias), which its softmax ignores too."""
    last = cfg.ce_model.num_layers - 1
    return name.endswith("attention.key.bias") or name in (
        f"bert.layers.{last}.output_layernorm.bias", "linear.bias")


@pytest.mark.parametrize("case", ["accum1", "accum2", "distill"])
def test_three_ce_steps_equal_jax_trainer(tmp_path, case):
    """From the same parameters and batches, the port's train step against
    the JAX CETrainer's jitted step: the optimizer too (its default
    TrainConfig, the no-decay mask over ``linear.bias`` and the LayerNorms)."""
    # the reference's CE learning rate, 1e-5: Adam's default eps (1e-8) turns an
    # element whose gradient is near eps into an update of up to ~lr whose
    # size hangs on that gradient's rounding, so a larger rate would move such
    # elements apart by more than the tolerance
    cfg = no_dropout(make_cfg(tmp_path, weight_decay=0.5, max_grad_norm=0.5, learning_rate=1e-5))
    if case == "accum2":
        cfg = with_ce(cfg, grad_accum_steps=2)
    if case == "distill":
        cfg = with_ce(cfg, distill_weight=0.4, distill_temperature=2.0)
    params = _flax_ce_params(cfg)
    j, t = _trainers(cfg, jax_init=params, port_init=state_dict_from_jax_params(params, cfg.ce_model))
    j._init_state(3)
    t._init_state(3)
    step_fn = j._train_step_fn()
    grad_fn = _jax_grad_fn(j, cfg)
    mode = "distill" if case == "distill" else "train"
    exs = distill_examples(6, seed=1) if mode == "distill" else make_examples(6, seed=1)
    for s in range(3):
        batch = exs[2 * s : 2 * s + 2]
        j.np_rng = np.random.default_rng((cfg.ce_train.seed, s))
        ids, attn, group, teacher = j._build_pairs(batch, mode)
        jteacher = teacher if teacher is not None else np.zeros((ids.shape[0] // group, group), np.float32)
        jgrads = _jax_flat(grad_fn(j.state.params, ids, attn, group, jteacher), cfg)
        j.state, jloss = step_fn(j.state, jax.random.fold_in(j.rng, s), ids, attn, group, jteacher)
        tloss = float(t.compute_grads(ids, attn, group, teacher, s))
        assert tloss == pytest.approx(float(jloss), abs=1e-5), f"loss at step {s}"
        largest = max(np.abs(w).max() for w in jgrads.values())
        for name, p in t.model.named_parameters():
            g, w = p.grad.numpy(), jgrads[name]
            if _zero_gradient(name, cfg):
                assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-5 * largest, f"{name} at step {s}"
            else:
                assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), f"{name} gradient at step {s}"
        t.optimizer.step()
        want = _jax_flat(j.state.params, cfg)
        for name, p in t.model.named_parameters():
            if not _zero_gradient(name, cfg):
                np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=1e-6,
                                           err_msg=f"{name} after step {s}")
    assert t.optimizer.count == int(j.state.step) == 3


def test_ce_optimizer_takes_train_config_defaults(tmp_path):
    """Only lr, weight decay and the clip come from ce_train; the decay mask
    leaves the head's bias and the LayerNorms alone."""
    from colbert_tpu_torch.models.convert import flax_paths
    from colbert_tpu_torch.training.train_state import no_decay

    cfg = make_cfg(tmp_path, learning_rate=2e-4, weight_decay=0.2, max_grad_norm=0.7)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, adam_b1=0.5, warmup_ratio=0.5))
    _, t = _trainers(cfg)
    t._init_state(10)
    groups = t.optimizer.adamw.param_groups
    assert [g["weight_decay"] for g in groups] == [0.2, 0.0]
    assert groups[0]["betas"] == (0.9, 0.999) and groups[0]["eps"] == 1e-8
    assert t.optimizer.max_grad_norm == 0.7 and t.optimizer.schedule(0) == 2e-4  # no warmup
    names = {id(p): n for n, p in t.model.named_parameters()}
    no = {names[id(p)] for p in groups[1]["params"]}
    assert "linear.bias" in no and "linear.weight" not in no
    paths = flax_paths(cfg.ce_model)
    assert no == {n for n in names.values() if no_decay(paths[n])}


# ---- evaluation and rerank ----

def test_dev_mrr_and_rerank_equal_jax(tmp_path):
    cfg = make_cfg(tmp_path)
    params = _flax_ce_params(cfg, seed=2, noise=0.3)
    j, t = _trainers(cfg, jax_init=params, port_init=state_dict_from_jax_params(params, cfg.ce_model))
    j._init_state(1)
    t._init_state(1)
    from colbert_tpu_torch.training import RetrievalDataset

    dev = RetrievalDataset(make_examples(7, seed=8))
    want, got = j.evaluate(dev), t.evaluate(dev)
    assert got == pytest.approx(want, abs=1e-12) and 0 < got <= 1
    cands = sorted({c for e in make_examples(10, seed=9) for c in e["hard_negative_ctxs"]})
    for q in ("find apple", "find ocean very"):
        want_order = [int(i) for i in j.rerank(q, cands, batch=8)]
        got_order = [int(i) for i in t.rerank(q, cands, batch=8)]
        assert got_order == want_order and sorted(got_order) == list(range(len(cands)))


# ---- checkpoints, resume, warm start ----

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port CE run with dropout on: 4 steps, checkpoints at 2 and 4, dev MRR at each."""
    from colbert_tpu_torch.training import CETrainer, RetrievalDataset

    tmp = tmp_path_factory.mktemp("ce")
    cfg = make_cfg(tmp, per_device_batch_size=2, evals_per_epoch=2)
    ds = RetrievalDataset(make_examples(8))
    a = CETrainer(cfg, port_tokenizer(cfg), device="cpu")
    losses = a.train(ds, dev_ds=RetrievalDataset(make_examples(3, seed=4)))
    return cfg, ds, a, losses


def test_ce_train_logs_and_checkpoints(trained):
    cfg, ds, a, losses = trained
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert a.ckpt.all_steps() == [2, 4]
    rows = [json.loads(l) for l in (a.ckpt.dir / "ce_train_log.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [2, 4] and all(0 < r["dev_mrr"] <= 1 for r in rows)
    assert [r["loss"] for r in rows] == [losses[1], losses[3]]
    steps = [json.loads(l) for l in (a.ckpt.dir / "ce_train_steps.jsonl").read_text().splitlines()]
    assert [s["step"] for s in steps] == [1, 2, 3, 4] and [s["loss"] for s in steps] == losses
    meta = a.ckpt.load_metadata(4)
    assert meta["config"] == json.loads(json.dumps(cfg.to_dict())) and "dev_mrr" in meta["metrics"]


def test_ce_resume_is_bit_exact(trained):
    from colbert_tpu_torch.training import CETrainer

    cfg, ds, a, losses = trained
    shutil.copytree(a.ckpt.path(4), a.ckpt.dir.parent / "kept-4")
    shutil.rmtree(a.ckpt.path(4))  # resume from step 2
    try:
        b = CETrainer(cfg, port_tokenizer(cfg), device="cpu")
        assert b.train(ds, resume=True) == losses[2:]
        for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
            assert torch.equal(pa, pb), name
        assert b.optimizer.count == a.optimizer.count == 4
    finally:
        shutil.rmtree(a.ckpt.path(4), ignore_errors=True)
        shutil.copytree(a.ckpt.dir.parent / "kept-4", a.ckpt.path(4))


def test_jax_package_reads_port_ce_checkpoint(trained):
    from colbert_tpu.models import CrossEncoderModel as FlaxCE
    from colbert_tpu.models.convert import ce_params_from_torch
    from colbert_tpu_torch.models.ce import CrossEncoderModel

    cfg, ds, a, _ = trained
    jc = to_jax_cfg(cfg)
    jparams = ce_params_from_torch(str(a.ckpt.params_path(2)), jc.ce_model)
    assert jparams["linear"]["bias"].shape == (1,)
    enc = _pair_batch(cfg)
    want = np.asarray(FlaxCE(jc.ce_model).apply({"params": jparams}, enc.input_ids, enc.attention_mask))
    m = CrossEncoderModel(cfg.ce_model)
    m.load_state_dict(a.load_params_for_inference(2))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(enc.input_ids), torch.from_numpy(enc.attention_mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_load_for_inference_builds_the_checkpoint_model(trained):
    """``load_for_inference`` builds the model from the checkpoint alone (no
    seeded init, no optimizer): its parameters and its rerank order equal
    those of a seeded model loaded with the same checkpoint."""
    from colbert_tpu_torch.training import CETrainer

    cfg, ds, a, _ = trained
    t = CETrainer(cfg, port_tokenizer(cfg), device="cpu")
    t.load_for_inference(2)
    assert t.optimizer is None
    ref = CETrainer(cfg, port_tokenizer(cfg), device="cpu")
    ref._init_state(1)
    ref.model.load_state_dict(a.load_params_for_inference(2))
    for (name, p), q in zip(t.model.named_parameters(), ref.model.parameters()):
        assert p.device.type == "cpu" and p.requires_grad and torch.equal(p, q), name
    ex = ds[0]
    cands = [ex["positive_ctxs"][0], *ex["hard_negative_ctxs"]]
    assert t.rerank(ex["question"], cands) == ref.rerank(ex["question"], cands)


def test_init_from_retriever_grafts_the_bert(trained, tmp_path):
    """``ce_train.init_from_retriever``: the latest retriever checkpoint's
    BERT goes into the CE, the head stays the fresh init."""
    from colbert_tpu_torch.cli import _ce_init_state_dict
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.training import CETrainer
    from colbert_tpu_torch.training.checkpoint import CheckpointManager
    from colbert_tpu_torch.models.convert import reference_state_dict

    cfg, *_ = trained
    cfg = dataclasses.replace(with_ce(cfg, init_from_retriever=True, checkpoint_dir=str(tmp_path / "ce")),
                              train=dataclasses.replace(cfg.train, checkpoint_dir=str(tmp_path / "retr")))
    with pytest.raises(SystemExit, match="no retriever parameters"):
        _ce_init_state_dict(cfg, None)
    retr = ColbertModel(cfg.model, cfg.multiview)
    retr.init_weights(torch.Generator().manual_seed(11))
    CheckpointManager(cfg.train.checkpoint_dir).save(5, reference_state_dict(retr.state_dict(), cfg.model), {})
    t = CETrainer(cfg, port_tokenizer(cfg), device="cpu", init_state_dict=_ce_init_state_dict(cfg, None))
    t._init_state(1)
    fresh = CETrainer(cfg, port_tokenizer(cfg), device="cpu")
    fresh._init_state(1)
    for name, v in retr.bert.state_dict().items():
        assert torch.equal(t.model.bert.state_dict()[name], v), name
    assert torch.equal(t.model.linear.weight, fresh.model.linear.weight)
    assert torch.equal(t.model.linear.bias, fresh.model.linear.bias)


def test_non_finite_ce_loss_raises(tmp_path):
    from colbert_tpu_torch.training import CETrainer, RetrievalDataset

    cfg = make_cfg(tmp_path, score_temperature=0.0)  # scores / 0 -> nan
    t = CETrainer(cfg, port_tokenizer(cfg), device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite CE loss"):
        t.train(RetrievalDataset(make_examples(4)))


def test_ce_train_loop_equals_jax(tmp_path):
    """``train`` end to end against the JAX ``CETrainer.train`` (dropout 0, the
    same parameters): the per-step pairs, epoch order and losses, the
    evaluation cadence and dev MRR, and the checkpoints (the final save of a
    run that ends between evaluations included)."""
    from colbert_tpu.training import RetrievalDataset as JDataset
    from colbert_tpu_torch.training import RetrievalDataset

    cfg = no_dropout(make_cfg(tmp_path, learning_rate=1e-5, evals_per_epoch=2, num_epochs=2))
    jcfg = with_ce(cfg, checkpoint_dir=str(tmp_path / "jax_ce"))
    params = _flax_ce_params(cfg, seed=5, noise=0.2)
    j, _ = _trainers(jcfg, jax_init=params)
    _, t = _trainers(cfg, port_init=state_dict_from_jax_params(params, cfg.ce_model))
    exs, dev = make_examples(11, seed=6), make_examples(5, seed=7)  # 5 steps an epoch: evaluations at 2 and 4
    want = j.train(JDataset(exs), dev_ds=JDataset(dev))
    got = t.train(RetrievalDataset(exs), dev_ds=RetrievalDataset(dev))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert len(got) == 10
    assert [r["step"] for r in t.log] == [r["step"] for r in j.log] == [2, 4, 6, 8, 10]
    np.testing.assert_allclose([r["dev_mrr"] for r in t.log], [r["dev_mrr"] for r in j.log], rtol=0, atol=1e-6)
    assert t.ckpt.all_steps() == j.ckpt.all_steps() == [2, 4, 6, 8, 10]
    short = with_ce(cfg, num_epochs=1, checkpoint_dir=str(tmp_path / "short"))
    _, s = _trainers(short)
    s.train(RetrievalDataset(exs))
    assert s.ckpt.all_steps() == [2, 4, 5]  # the final save after step 5

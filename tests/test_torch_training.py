"""Retriever training of the port against the JAX package, on the CPU, at a tiny size.

* losses and ranks: equal to ``colbert_tpu.training.losses`` (ties and -inf
  pad columns included), within 1e-6;
* sampler: the same batches as ``colbert_tpu.training.RetrievalSampler``,
  array for array (each package with its own tokenizer);
* optimizer: equal to ``make_optimizer``'s optax chain within 1e-6;
* train step, dropout off: from the same parameters (the Flax init,
  converted) and the same batches, against the JAX trainer's own jitted
  step: loss within 1e-5, every gradient within 1e-4 of its tensor's
  largest entry, parameters within 1e-6 after each of three updates, at
  ``grad_accum_steps`` 1 and 2.  Both sides compute in fp32 and differ
  only in operation order;
* the train loop, dropout off, two epochs: every step's loss within 1e-5
  and every evaluation's metrics within 1e-6 of the JAX trainer's
  ``train``, the same checkpoints;
* resume: N steps straight equal k steps, a checkpoint, and a resume,
  bit for bit;
* checkpoints: the JAX package reads a port checkpoint's ``pytorch.bin``
  and encodes as the port does, within 1e-4;
* the CLI trains on the CPU and encodes and evaluates from its checkpoint.
"""

import dataclasses
import json
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import colbert_tpu.config as jcfg
import colbert_tpu_torch.config as tcfg
from colbert_tpu.training import losses as jl
from colbert_tpu_torch.models.convert import state_dict_from_jax_params
from colbert_tpu_torch.training import losses as tl

WORDS = ["apple", "river", "mountain", "piano", "dragon", "silver", "ocean", "candle", "forest", "marble"]


def make_examples(n, seed=0):
    """Synthetic retrieval data of varied lengths: the positive repeats the question's word."""
    rng = np.random.default_rng(seed)
    exs = []
    for i in range(n):
        w = WORDS[i % len(WORDS)]
        others = [x for x in WORDS if x != w]
        exs.append({
            "question": f"find {w} " + "very " * int(rng.integers(0, 4)),
            "positive_ctxs": [f"{w} {w} text about {w}" + " more" * int(rng.integers(0, 12)),
                              f"{w} again"][: int(rng.integers(1, 3))],
            "hard_negative_ctxs": [f"{o} stuff {o}" + " x" * int(rng.integers(0, 15))
                                   for o in rng.permutation(others)][: int(rng.integers(1, 9))],
        })
    return exs


def make_cfg(tmp_path, **train_kw):
    from colbert_tpu_torch.tokenization import build_vocab, write_vocab

    vp = write_vocab(build_vocab([" ".join(WORDS), "find text about stuff very more again x"]),
                     tmp_path / "vocab.txt")
    train = dict(learning_rate=1e-3, per_device_batch_size=2, num_epochs=1, eval_num_positives=1,
                 eval_num_negatives=3, log_every=1, checkpoint_dir=str(tmp_path / "ckpt"), seed=0)
    train.update(train_kw)
    return tcfg.ColbertConfig(
        model=tcfg.ModelConfig(vocab_size=128, hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64,
                               max_position_embeddings=64, dim=16, dtype="float32"),
        multiview=tcfg.MultiviewConfig(enabled=True, q_view=4, d_view=4),
        tokenizer=tcfg.TokenizerConfig(vocab_path=vp, query_maxlen=12, doc_maxlen=24),
        train=tcfg.TrainConfig(**train),
        index=tcfg.IndexConfig(pq_m=4, index_path=str(tmp_path / "index"), num_parts=2),
        serve=tcfg.ServeConfig(mode="flat", topk=5, query_batch_size=4),
    )


def to_jax_cfg(cfg):
    return jcfg.ColbertConfig.from_dict(cfg.to_dict())


# ---- losses and ranks ----

def _scores_with_ties():
    rng = np.random.default_rng(0)
    s = rng.integers(0, 4, size=(6, 18)).astype(np.float32)  # many ties
    s[4:, :] = 1.0                                           # whole rows tied
    s[:, 15:] = -np.inf                                      # pad columns of a partial eval batch
    return s


@pytest.mark.parametrize("group,num_pos", [(3, 1), (3, 2)])
def test_ranks_equal_jax(group, num_pos):
    s = _scores_with_ties()
    for fn in ("positive_ranks", "reciprocal_ranks"):
        want = np.asarray(getattr(jl, fn)(jnp.asarray(s), group, num_pos))
        got = getattr(tl, fn)(torch.from_numpy(s), group, num_pos).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_nll_loss_equal_jax():
    s = np.random.default_rng(1).normal(size=(5, 10)).astype(np.float32) * 20
    labels = np.arange(5) * 2
    want = float(jl.biencoder_nll_loss(jnp.asarray(s), jnp.asarray(labels)))
    got = float(tl.biencoder_nll_loss(torch.from_numpy(s), torch.from_numpy(labels)))
    assert got == pytest.approx(want, rel=1e-6)  # fp32, two summation orders


# ---- sampler ----

@pytest.mark.parametrize("multiview", [True, False])
def test_sampler_batches_equal_jax(tmp_path, multiview):
    from colbert_tpu.tokenization import ColbertTokenizer as JaxTokenizer
    from colbert_tpu.training import RetrievalDataset as JDataset, RetrievalSampler as JSampler
    from colbert_tpu_torch.tokenization import ColbertTokenizer
    from colbert_tpu_torch.training import RetrievalDataset, RetrievalSampler

    cfg = make_cfg(tmp_path, doc_length_buckets=(12, 16, 20), length_group_pool=2, seed=5, train_negative_pool=4)
    cfg.multiview.enabled = multiview
    jc = to_jax_cfg(cfg)
    exs = make_examples(23, seed=4)
    for is_eval, epochs in ((False, (0, 1)), (True, (0,))):
        t = RetrievalSampler(RetrievalDataset(exs), ColbertTokenizer(cfg.tokenizer, cfg.multiview), cfg.train,
                             4, is_eval=is_eval, drop_last=not is_eval)
        j = JSampler(JDataset(exs), JaxTokenizer(jc.tokenizer, jc.multiview), jc.train, 4,
                     is_eval=is_eval, drop_last=not is_eval)
        assert t.steps_per_epoch() == j.steps_per_epoch()
        lengths = set()
        for e in epochs:
            tb, jb = list(t.epoch(e)), list(j.epoch(e))
            assert len(tb) == len(jb) > 0
            for a, b in zip(tb, jb):
                for name in ("q_ids", "q_attn", "q_active", "d_ids", "d_attn", "d_active"):
                    np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
                lengths.add(a.d_ids.shape[1])
        assert is_eval or len(lengths) > 1  # the buckets cut some batches


def _raises_within(fn, timeout=30.0):
    """Run ``fn`` in a thread, joined with a timeout so a hang cannot stall
    the suite; returns the exception it raised (None if none)."""
    import threading

    out = {}

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 -- returned to the test
            out["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout)
    assert not t.is_alive(), f"still blocked after {timeout} s"
    return out.get("error")


def _failing_make_batch(orig, fail_at=2):
    calls = []

    def make_batch(self, idxs):
        calls.append(1)
        if len(calls) == fail_at:
            raise ValueError("a batch that cannot be built")
        return orig(self, idxs)

    return make_batch


def test_sampler_producer_error_reaches_the_caller(tmp_path, monkeypatch):
    """An exception while building a batch in the producer thread is raised
    by the iteration, instead of leaving the consumer waiting on the queue."""
    from colbert_tpu_torch.tokenization import ColbertTokenizer
    from colbert_tpu_torch.training import RetrievalDataset, RetrievalSampler

    cfg = make_cfg(tmp_path)
    monkeypatch.setattr(RetrievalSampler, "_make_batch", _failing_make_batch(RetrievalSampler._make_batch))
    sampler = RetrievalSampler(RetrievalDataset(make_examples(8)), ColbertTokenizer(cfg.tokenizer, cfg.multiview),
                               cfg.train, 2)
    got = []
    err = _raises_within(lambda: got.extend(sampler.epoch(0)))
    assert isinstance(err, ValueError) and "cannot be built" in str(err)
    assert len(got) == 1  # the batch before the failure was delivered


def test_trainer_raises_a_sampler_error(tmp_path, monkeypatch):
    from colbert_tpu_torch.tokenization import ColbertTokenizer
    from colbert_tpu_torch.training import ColbertTrainer, RetrievalDataset, RetrievalSampler

    cfg = make_cfg(tmp_path)
    monkeypatch.setattr(RetrievalSampler, "_make_batch", _failing_make_batch(RetrievalSampler._make_batch))
    trainer = ColbertTrainer(cfg, ColbertTokenizer(cfg.tokenizer, cfg.multiview), device="cpu")
    err = _raises_within(lambda: trainer.train(RetrievalDataset(make_examples(8))))
    assert isinstance(err, ValueError) and "cannot be built" in str(err)


# ---- optimizer ----

def test_optimizer_equals_optax():
    """Clip, AdamW with the flax-path decay mask, and the schedule: the port's
    Optimizer against ``make_optimizer`` on the same parameters and gradients."""
    import optax

    from colbert_tpu.training.train_state import make_optimizer
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.training.train_state import Optimizer

    cfg = dataclasses.replace(tcfg.TrainConfig(), learning_rate=1e-2, weight_decay=0.3, warmup_ratio=0.4,
                              max_grad_norm=0.5)
    mcfg = tcfg.ModelConfig(vocab_size=20, hidden_size=8, num_layers=1, num_heads=2, intermediate_size=16,
                            max_position_embeddings=8, dim=4, dtype="float32")
    model = ColbertModel(mcfg, tcfg.MultiviewConfig())
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.1)
    opt = Optimizer(model, cfg, mcfg, total_steps=5)
    names = dict(model.named_parameters())
    jparams = {k: jnp.asarray(v.detach().numpy()) for k, v in names.items()}
    # optax sees the flax paths: key the pytree by them
    from colbert_tpu_torch.models.convert import flax_paths

    paths = flax_paths(mcfg)

    def nest(flat):
        out = {}
        for k, v in flat.items():
            node = out
            parts = paths[k].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        return out

    tx = make_optimizer(to_jax_cfg(tcfg.ColbertConfig(train=cfg)).train, 5)
    jp = nest(jparams)
    state = tx.init(jp)
    rng = np.random.default_rng(9)
    for step in range(5):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) * (0.05 if step % 2 else 1.0)
                 for k, v in names.items()}
        for k, p in names.items():
            p.grad = torch.from_numpy(grads[k].copy())
        opt.step()
        upd, state = tx.update(nest({k: jnp.asarray(g) for k, g in grads.items()}), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in names.items():
            node = jp
            for part in paths[k].split("/"):
                node = node[part]
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(node), rtol=0, atol=1e-6,
                                       err_msg=f"{k} after step {step}")


# ---- the train step against the JAX trainer ----

def _random_batches(cfg, n, seed):
    from colbert_tpu_torch.training import TrainBatch

    rng = np.random.default_rng(seed)
    B = cfg.train.per_device_batch_size
    group = cfg.train.train_num_positives + cfg.train.train_num_negatives
    Lq, Ld = cfg.tokenizer.query_maxlen, cfg.tokenizer.doc_maxlen
    qv, dv = cfg.multiview.q_view, cfg.multiview.d_view

    def side(rows, L, lo):
        ids = rng.integers(1, cfg.model.vocab_size, size=(rows, L)).astype(np.int32)
        lens = rng.integers(lo, L + 1, size=rows)
        attn = (np.arange(L)[None, :] < lens[:, None]).astype(np.int32)
        return ids * attn, attn

    out = []
    for _ in range(n):
        q_ids, q_attn = side(B, Lq, qv)
        d_ids, d_attn = side(B * group, Ld, dv)
        out.append(TrainBatch(q_ids, q_attn, np.ones((B, qv), np.int32), d_ids, d_attn,
                              np.ones((B * group, dv), np.int32)))
    return out


def _flat_jax_params(params, cfg):
    return {k: v.numpy() for k, v in state_dict_from_jax_params(jax.tree.map(np.asarray, params), cfg.model).items()}


@pytest.fixture(scope="module")
def step_setup(tmp_path_factory):
    from colbert_tpu.models import ColbertModel as FlaxColbert

    tmp = tmp_path_factory.mktemp("step")
    # adam_eps 1e-6: the key biases' gradients are exactly zero up to rounding
    # noise (~1e-9), which Adam would otherwise scale up to ~lr/10 per step
    cfg = make_cfg(tmp, learning_rate=1e-4, weight_decay=0.5, warmup_ratio=0.34, max_grad_norm=0.5,
                   per_device_batch_size=4, adam_eps=1e-6)
    cfg.model.hidden_dropout = cfg.model.attention_dropout = 0.0
    model = FlaxColbert(to_jax_cfg(cfg).model, to_jax_cfg(cfg).multiview)
    z = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(7), z, jnp.ones_like(z), z, jnp.ones_like(z))["params"]
    rng = np.random.default_rng(11)  # non-trivial LayerNorm and bias parameters
    params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.05, size=a.shape).astype(np.float32), params)
    return cfg, params, _random_batches(cfg, 3, seed=3)


def _jax_trainer(cfg, params, total_steps):
    from colbert_tpu.parallel import make_mesh
    from colbert_tpu.training import ColbertTrainer as JaxTrainer

    mesh = make_mesh(data=1, model=1, devices=jax.devices()[:1])
    t = JaxTrainer(to_jax_cfg(cfg), None, mesh=mesh, init_params=params, total_steps=total_steps)
    t._init_state(total_steps)
    return t


def _port_trainer(cfg, params, total_steps):
    from colbert_tpu_torch.training import ColbertTrainer

    t = ColbertTrainer(cfg, None, device="cpu", init_state_dict=state_dict_from_jax_params(params, cfg.model),
                       total_steps=total_steps)
    t._init_state(total_steps)
    return t


def test_gradients_equal_jax(step_setup):
    from colbert_tpu.models import ColbertModel as FlaxColbert
    from colbert_tpu.ops.maxsim import maxsim_xla

    cfg, params, batches = step_setup
    b = batches[0]
    jc = to_jax_cfg(cfg)
    model = FlaxColbert(jc.model, jc.multiview)
    group = cfg.train.train_num_positives + cfg.train.train_num_negatives

    def loss_fn(p):
        Q = model.apply({"params": p}, b.q_ids, b.q_attn, deterministic=False, method=model.query,
                        rngs={"dropout": jax.random.PRNGKey(0)})
        D = model.apply({"params": p}, b.d_ids, b.d_attn, deterministic=False, method=model.doc,
                        rngs={"dropout": jax.random.PRNGKey(1)})
        scores = maxsim_xla(Q, D, b.q_active, b.d_active) / cfg.train.score_temperature
        return jl.biencoder_nll_loss(scores, jnp.arange(scores.shape[0]) * group)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, params))
    port = _port_trainer(cfg, params, 3)
    tloss = float(port.compute_grads(b, 0))
    assert tloss == pytest.approx(float(jloss), abs=1e-5)
    want = _flat_jax_params(jgrads, cfg)
    largest = max(np.abs(w).max() for w in want.values())
    for name, p in port.model.named_parameters():
        g, w = p.grad.numpy(), want[name]
        if name.endswith("attention.key.bias"):
            # exactly zero: a key bias shifts each query's logits by a constant,
            # which the softmax ignores; both sides hold rounding noise only
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * largest, name
            continue
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name


@pytest.mark.parametrize("accum", [1, 2])
def test_three_steps_equal_jax_trainer(step_setup, accum):
    cfg, params, batches = step_setup
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, grad_accum_steps=accum))
    jt = _jax_trainer(cfg, params, 3)
    step_fn = jt._train_step_fn()
    pt = _port_trainer(cfg, params, 3)
    for s, b in enumerate(batches):
        jt.state, jloss = step_fn(jt.state, jax.random.fold_in(jt.rng, s), *jt._shard_batch(b))
        tloss = float(pt.train_step(b, s))
        assert tloss == pytest.approx(float(jloss), abs=1e-5), f"loss at step {s}"
        want = _flat_jax_params(jt.state.params, cfg)
        for name, p in pt.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0, atol=1e-6,
                                       err_msg=f"{name} after step {s}")
    assert pt.optimizer.count == int(jt.state.step) == 3


# ---- resume, checkpoints, CLI ----

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port trainer with dropout on, 4 steps of one epoch, checkpoints at 2 and 4."""
    from colbert_tpu_torch.tokenization import ColbertTokenizer
    from colbert_tpu_torch.training import ColbertTrainer, RetrievalDataset

    tmp = tmp_path_factory.mktemp("resume")
    cfg = make_cfg(tmp, evals_per_epoch=2)
    tok = ColbertTokenizer(cfg.tokenizer, cfg.multiview)
    ds = RetrievalDataset(make_examples(8))
    a = ColbertTrainer(cfg, tok, device="cpu")
    a.train(ds, dev_ds=RetrievalDataset(make_examples(3, seed=9)))
    return cfg, tok, ds, a


def test_resume_is_bit_exact(trained):
    from colbert_tpu_torch.training import ColbertTrainer

    cfg, tok, ds, a = trained
    assert a.ckpt.all_steps() == [2, 4]
    assert [s["step"] for s in a.log.steps] == [1, 2, 3, 4] and len(a.log.evals) == 2
    meta = a.ckpt.load_metadata(4)
    assert meta["config"] == json.loads(json.dumps(cfg.to_dict())) and "eval_mrr" in meta["metrics"]
    shutil.copytree(a.ckpt.path(4), a.ckpt.dir.parent / "kept-4")
    shutil.rmtree(a.ckpt.path(4))  # resume from step 2
    b = ColbertTrainer(cfg, tok, device="cpu")
    b.train(ds, resume=True)
    assert [s["step"] for s in b.log.steps] == [3, 4]
    assert [s["step_loss"] for s in b.log.steps] == [s["step_loss"] for s in a.log.steps[2:]]
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(pa, pb), name
    assert b.optimizer.count == a.optimizer.count == 4


def test_jax_package_reads_port_checkpoint(trained):
    from colbert_tpu.models import ColbertModel as FlaxColbert
    from colbert_tpu.models.convert import colbert_params_from_torch

    cfg, tok, ds, a = trained
    step = a.ckpt.latest_step()
    jc = to_jax_cfg(cfg)
    jparams = colbert_params_from_torch(str(a.ckpt.params_path(step)), jc.model)
    enc = tok.encode_docs([e["positive_ctxs"][0] for e in make_examples(3)])
    fm = FlaxColbert(jc.model, jc.multiview)
    want = np.asarray(fm.apply({"params": jparams}, enc.input_ids, enc.attention_mask, method=fm.doc))
    from colbert_tpu_torch.models.colbert import ColbertModel

    m = ColbertModel(cfg.model, cfg.multiview)
    m.load_state_dict(a.load_params_for_inference(step))
    with torch.no_grad():
        got = m.eval().doc(torch.from_numpy(enc.input_ids), torch.from_numpy(enc.attention_mask)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_evaluate_checkpoints_restores_live_params(trained):
    from colbert_tpu_torch.training import RetrievalDataset

    cfg, tok, ds, a = trained
    before = {k: v.clone() for k, v in a.model.state_dict().items()}
    out = a.evaluate_checkpoints(RetrievalDataset(make_examples(3, seed=9)))
    assert sorted(out) == a.ckpt.all_steps() and all(np.isfinite(m["eval_mrr"]) for m in out.values())
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_non_finite_loss_raises(tmp_path):
    from colbert_tpu_torch.tokenization import ColbertTokenizer
    from colbert_tpu_torch.training import ColbertTrainer, RetrievalDataset

    cfg = make_cfg(tmp_path, score_temperature=0.0)  # scores / 0 -> nan
    t = ColbertTrainer(cfg, ColbertTokenizer(cfg.tokenizer, cfg.multiview), device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite loss"):
        t.train(RetrievalDataset(make_examples(4)))


def test_bare_bert_pretrain_keeps_fresh_head(trained, tmp_path):
    """``--pretrain`` of a bare BERT (HF ``bert.*`` keys, no ``linear.weight``):
    the encoder loads, the head stays the fresh init (the strict=False analogue)."""
    from colbert_tpu_torch.models.convert import state_dict_from_reference
    from colbert_tpu_torch.training import ColbertTrainer

    cfg, tok, ds, a = trained
    sd = torch.load(a.ckpt.params_path(a.ckpt.latest_step()), weights_only=True)
    bare = {"bert." + k[len("model."):]: v for k, v in sd.items() if k.startswith("model.")}
    init = state_dict_from_reference(bare, cfg.model, require_head=False)
    assert "linear.weight" not in init
    t = ColbertTrainer(cfg, tok, device="cpu", init_state_dict=init)
    t._init_state(1)
    fresh = ColbertTrainer(cfg, tok, device="cpu")
    fresh._init_state(1)
    assert torch.equal(t.model.linear.weight, fresh.model.linear.weight)
    assert torch.equal(t.model.bert.layers[0].output.weight, a.model.bert.layers[0].output.weight)


def test_cli_trains_then_encodes_and_evaluates_from_checkpoint(tmp_path, capsys):
    from colbert_tpu_torch.cli import main

    cfg = make_cfg(tmp_path, evals_per_epoch=1)
    conf = tmp_path / "conf.yaml"
    cfg.to_yaml(conf)
    exs = make_examples(6)
    (tmp_path / "train.json").write_text(json.dumps(exs))
    (tmp_path / "dev.json").write_text(json.dumps(make_examples(3, seed=2)))
    docs = sorted({d for e in exs for d in e["positive_ctxs"] + e["hard_negative_ctxs"]})
    (tmp_path / "corpus.json").write_text(json.dumps(docs))
    (tmp_path / "eval.json").write_text(json.dumps(
        [{"question": d, "positive_ctxs": [d]} for d in docs[:3]]))
    common = ["--config", str(conf), "--device", "cpu"]

    with pytest.raises(SystemExit, match="no --pretrain <pytorch.bin> and no checkpoint under"):
        main(["encode", "--corpus", str(tmp_path / "corpus.json"), *common])
    main(["train", "--train-data", str(tmp_path / "train.json"), "--dev-data", str(tmp_path / "dev.json"), *common])
    assert (tmp_path / "ckpt" / "checkpoint-3" / "pytorch.bin").exists()
    main(["encode", "--corpus", str(tmp_path / "corpus.json"), *common])
    assert (tmp_path / "index" / "meta.json").exists()
    capsys.readouterr()
    main(["evaluate", "--eval-data", str(tmp_path / "eval.json"), "--corpus", str(tmp_path / "corpus.json"),
          "--topk", "5", "--checkpoint-step", "3", *common])
    metrics = json.loads(capsys.readouterr().out)
    assert set(metrics) == {"mrr@10", "recall@50", "recall@100"}
    with pytest.raises(SystemExit, match="no checkpoint 9"):
        main(["encode", "--corpus", str(tmp_path / "corpus.json"), *common, "--checkpoint-step", "9"])


class SerialTokenizer:
    """A JAX ``ColbertTokenizer`` whose calls run one at a time.  Its HF fast
    tokenizer raises "Already borrowed" when two threads encode at once with
    different lengths, and the JAX trainer's evaluation tokenizes its dev
    batches in a producer thread while the train epoch's producer still
    tokenizes ahead; the JAX sampler's producer then dies without its
    sentinel and the evaluation waits for ever (a whole run of the suite
    under xdist then ends at its time limit)."""

    def __init__(self, tok):
        self._tok, self._lock = tok, threading.Lock()

    def __getattr__(self, name):
        attr = getattr(self._tok, name)
        if not callable(attr):
            return attr

        def call(*args, **kwargs):
            with self._lock:
                return attr(*args, **kwargs)
        return call


def test_train_loop_equals_jax_trainer(tmp_path):
    """``train`` end to end against the JAX ``ColbertTrainer.train`` (dropout
    off, the same parameters, two epochs): the losses of every step, the
    evaluation cadence and its metrics, and the checkpoints saved."""
    from colbert_tpu.models import ColbertModel as FlaxColbert
    from colbert_tpu.tokenization import ColbertTokenizer as JaxTokenizer
    from colbert_tpu.training import RetrievalDataset as JDataset
    from colbert_tpu_torch.tokenization import ColbertTokenizer
    from colbert_tpu_torch.training import RetrievalDataset

    cfg = make_cfg(tmp_path, learning_rate=1e-4, evals_per_epoch=2, num_epochs=2, adam_eps=1e-6)
    cfg.model.hidden_dropout = cfg.model.attention_dropout = 0.0
    jc = to_jax_cfg(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_dir=str(tmp_path / "j"))))
    z = jnp.zeros((1, 8), jnp.int32)
    params = FlaxColbert(jc.model, jc.multiview).init(jax.random.PRNGKey(7), z, jnp.ones_like(z), z,
                                                      jnp.ones_like(z))["params"]
    params = jax.tree.map(np.asarray, params)
    exs, dev = make_examples(9), make_examples(5, seed=9)  # 4 steps an epoch: evaluations at 2 and 4
    from colbert_tpu.parallel import make_mesh
    from colbert_tpu.training import ColbertTrainer as JaxTrainer
    from colbert_tpu_torch.training import ColbertTrainer

    jt = JaxTrainer(jc, SerialTokenizer(JaxTokenizer(jc.tokenizer, jc.multiview)), init_params=params,
                    mesh=make_mesh(data=1, model=1, devices=jax.devices()[:1]))
    want = jt.train(JDataset(exs), dev_ds=JDataset(dev))
    pt = ColbertTrainer(cfg, ColbertTokenizer(cfg.tokenizer, cfg.multiview), device="cpu",
                        init_state_dict=state_dict_from_jax_params(params, cfg.model))
    got = pt.train(RetrievalDataset(exs), dev_ds=RetrievalDataset(dev))
    assert [s["step"] for s in got.steps] == [s["step"] for s in want.steps] == list(range(1, 9))
    np.testing.assert_allclose([s["loss"] for s in got.steps], [s["loss"] for s in want.steps], rtol=0, atol=1e-5)
    assert len(got.evals) == len(want.evals) == 4
    for g, w in zip(got.evals, want.evals):
        assert g.keys() == w.keys()
        np.testing.assert_allclose(list(g.values()), list(w.values()), rtol=0, atol=1e-6)
    assert pt.ckpt.all_steps() == jt.ckpt.all_steps() == [2, 4, 6, 8]

"""Tensor parallelism of the port (``mesh.model > 1``, ``models/sharding.py``)
against the JAX package and the port's own ``model = 1``, on the CPU, at
the tiny size of ``tests/test_training.py`` (hidden 32, 2 layers, 2 heads):
both positions of the model group on ``cpu``.

* the split rule: the port's ``spec_for`` equals the JAX package's
  ``_spec_for`` on every flax path of ColBERT and the CE, with and without
  ``fused_qkv``; ``shard_state`` splits by it and ``gather_state`` undoes it;
* the forward: the JAX model applied with ``shard_params`` on a ``data 1 x
  model 2`` CPU mesh against the port at ``model = 2`` from the same numpy
  weights, query and doc reps and CE logits within fp32 atol 1e-5 (as
  ``tests/test_models.py`` holds JAX's sharded forward);
* one train step, dropout off, against the JAX trainer's step at the same
  mesh (retriever and CE, global-norm clipping engaged and not): the loss
  within 1e-5 and every parameter within 1e-6 after the step (the limits of
  ``test_torch_training.py``: fp32 on both sides, only the order of sums
  differs);
* ``model = 2`` against ``model = 1`` with K9's plain version on (dropout
  "byte", the explicit attention's two dropout sites and flash): every
  site's mask bit-equal (a position's slices put together), the loss within
  ``TOL_TP`` of its size and every gradient within 1e-5 of the largest (sum
  order: a row-parallel product is two half sums added after, its bias
  after that, and the scores are divided by the temperature, 0.05);
* K9's strided counters: a slice's plain-version mask equals that slice of
  the whole tensor's mask, for the probabilities' heads and the attention
  output's columns, with a data-parallel ``row0`` folded in; the kernel's
  division constants are exact;
* checkpoints: written at ``model = 2`` in the ``model = 1`` format, loaded
  at either mesh; resuming at ``model = 2`` reproduces an uninterrupted run
  bit for bit; a sharded model's ``state_dict`` is the full layout, and a
  model sharded over one group and placed on another computes as before.

Serving at ``model = 2`` (encode, the flat, sharded and DPR searchers)
is in ``test_torch_tensor_parallel_serve.py``.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu_torch.models.convert import state_dict_from_jax_params
from tests.test_torch_training import _flat_jax_params, _random_batches, make_cfg, make_examples, to_jax_cfg

torch.set_num_threads(2)

M = 2  # model positions
GROUP = ["cpu"] * M
TOL_TP = 1e-5  # relative, a loss at model 2 against model 1: fp32 sums in another order, over 20x the scores


def tp(cfg, model=M):
    return dataclasses.replace(cfg, mesh=dataclasses.replace(cfg.mesh, model=model))


def noisy_params(init, shapes_of, seed):
    """A JAX init plus noise: non-trivial LayerNorm, bias and head parameters."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.05, size=a.shape).astype(np.float32),
                        init(shapes_of))


def jax_mesh(model=M):
    from colbert_tpu.parallel import make_mesh

    return make_mesh(data=1, model=model, devices=jax.devices()[:model])


# ---- the split rule ----

@pytest.mark.parametrize("kind", ["colbert", "ce"])
@pytest.mark.parametrize("fused", [False, True])
def test_split_rule_equals_jax(tmp_path, kind, fused):
    from colbert_tpu.models import ColbertModel as FlaxColbert
    from colbert_tpu.models import CrossEncoderModel as FlaxCE
    from colbert_tpu.models.sharding import _spec_for
    from colbert_tpu_torch.models.convert import flax_paths
    from colbert_tpu_torch.models.sharding import gather_state, shard_state, spec_for, split_dim

    cfg = make_cfg(tmp_path)
    cfg.model.fused_qkv = fused
    jc = to_jax_cfg(cfg)
    z = jnp.zeros((1, 8), jnp.int32)
    if kind == "colbert":
        shapes = jax.eval_shape(FlaxColbert(jc.model, jc.multiview).init, jax.random.PRNGKey(0), z, z, z, z)
    else:
        shapes = jax.eval_shape(FlaxCE(jc.model).init, jax.random.PRNGKey(0), z, z)
    flat = {"/".join(k.key for k in kp): leaf for kp, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    flat = {k[len("params/"):]: v for k, v in flat.items()}
    split = 0
    for path, leaf in flat.items():
        assert spec_for(path, leaf.ndim) == tuple(_spec_for(path, leaf.ndim)), path
        split += bool(spec_for(path, leaf.ndim))
    assert split == 6 * cfg.model.num_layers  # q, k, v, out, intermediate, output kernels
    paths = flax_paths(cfg.model)
    port_paths = {p for n, p in paths.items() if kind == "ce" or n != "linear.bias"}
    assert port_paths == set(flat)
    # the port's split dims: JAX's (in, out) kernel dims transposed to torch's (out, in)
    rng = np.random.default_rng(1)
    state = {n: torch.from_numpy(rng.normal(size=flat[p].shape[::-1] if flat[p].ndim == 2 else flat[p].shape)
                                 .astype(np.float32)) for n, p in paths.items() if p in flat}
    shards = shard_state(state, cfg.model, M)
    for name, t in state.items():
        spec = tuple(_spec_for(paths[name], t.dim()))
        if not spec:
            assert shards[name] is t and split_dim(paths[name], t.dim()) is None
            continue
        jax_dim = spec.index("model")
        dim = split_dim(paths[name], t.dim())
        assert dim == 1 - jax_dim, name
        for p in range(M):
            want = t.narrow(dim, p * t.shape[dim] // M, t.shape[dim] // M)
            assert torch.equal(shards[f"{name}.{p}"], want), name
    back = gather_state(shards, cfg.model)
    assert list(back) == list(state) and all(torch.equal(back[n], state[n]) for n in state)


def test_uneven_heads_are_refused(tmp_path):
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.models.sharding import place

    cfg = make_cfg(tmp_path)
    with pytest.raises(NotImplementedError, match="step 10"):
        place(ColbertModel(cfg.model, cfg.multiview), ["cpu"] * 3)


# ---- the forward against JAX's sharded forward ----

@pytest.mark.parametrize("kind", ["colbert", "ce"])
def test_forward_equals_jax_sharded(tmp_path, kind):
    from colbert_tpu.models import ColbertModel as FlaxColbert
    from colbert_tpu.models import CrossEncoderModel as FlaxCE
    from colbert_tpu.models.sharding import shard_params
    from colbert_tpu_torch.models.ce import CrossEncoderModel
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.models.sharding import place

    cfg = make_cfg(tmp_path)
    jc = to_jax_cfg(cfg)
    b = _random_batches(cfg, 1, seed=2)[0]
    if kind == "colbert":
        fm = FlaxColbert(jc.model, jc.multiview)
        z = jnp.zeros((1, 8), jnp.int32)
        params = noisy_params(lambda k: fm.init(k, z, z + 1, z, z + 1)["params"], jax.random.PRNGKey(3), 4)
        sharded = shard_params(params, jax_mesh())
        run = jax.jit(lambda p: (fm.apply({"params": p}, b.q_ids, b.q_attn, method=fm.query),
                                 fm.apply({"params": p}, b.d_ids, b.d_attn, method=fm.doc)))
        port = ColbertModel(cfg.model, cfg.multiview)
    else:
        fm = FlaxCE(jc.model)
        z = jnp.zeros((1, 8), jnp.int32)
        params = noisy_params(lambda k: fm.init(k, z, z + 1)["params"], jax.random.PRNGKey(3), 4)
        sharded = shard_params(params, jax_mesh())
        run = jax.jit(lambda p: (fm.apply({"params": p}, b.d_ids, b.d_attn),))
        port = CrossEncoderModel(cfg.model)
    want = [np.asarray(w) for w in run(sharded)]
    port.load_state_dict(state_dict_from_jax_params(params, cfg.model))
    place(port, GROUP).eval()
    assert port.model_group == tuple(torch.device(d) for d in GROUP)
    with torch.no_grad():
        if kind == "colbert":
            got = [port.query(torch.from_numpy(b.q_ids), torch.from_numpy(b.q_attn)).numpy(),
                   port.doc(torch.from_numpy(b.d_ids), torch.from_numpy(b.d_attn)).numpy()]
        else:
            got = [port(torch.from_numpy(b.d_ids), torch.from_numpy(b.d_attn)).numpy()]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.abs(w).max() > 0.1
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


# ---- one train step against the JAX trainer at mesh 1 x 2 ----

def _grad_norm(model):
    return float(torch.linalg.vector_norm(torch.stack([p.grad.norm() for p in model.parameters()])))


@pytest.mark.parametrize("max_grad_norm", [1e-3, 1e3], ids=["clipped", "unclipped"])
def test_retriever_step_equals_jax_trainer(tmp_path, max_grad_norm):
    from colbert_tpu.models import ColbertModel as FlaxColbert
    from colbert_tpu.training import ColbertTrainer as JaxTrainer
    from colbert_tpu_torch.training import ColbertTrainer

    cfg = tp(make_cfg(tmp_path, learning_rate=1e-4, weight_decay=0.5, warmup_ratio=0.0, max_grad_norm=max_grad_norm,
                      per_device_batch_size=4, adam_eps=1e-6))
    cfg.model.hidden_dropout = cfg.model.attention_dropout = 0.0
    jc = to_jax_cfg(cfg)
    fm = FlaxColbert(jc.model, jc.multiview)
    z = jnp.zeros((1, 8), jnp.int32)
    params = noisy_params(lambda k: fm.init(k, z, z + 1, z, z + 1)["params"], jax.random.PRNGKey(7), 11)
    b = _random_batches(cfg, 1, seed=3)[0]
    jt = JaxTrainer(jc, None, mesh=jax_mesh(), init_params=params, total_steps=2)
    jt._init_state(2)
    jt.state, jloss = jt._train_step_fn()(jt.state, jax.random.fold_in(jt.rng, 0), *jt._shard_batch(b))
    pt = ColbertTrainer(cfg, None, device="cpu", init_state_dict=state_dict_from_jax_params(params, cfg.model),
                        total_steps=2)
    pt._init_state(2)
    assert pt.model.model_group == (torch.device("cpu"),) * M
    tloss = float(pt.compute_grads(b, 0))
    assert (_grad_norm(pt.model) > max_grad_norm) == (max_grad_norm < 1)  # the clip engages, or not
    pt.optimizer.step()
    assert tloss == pytest.approx(float(jloss), abs=1e-5)
    want = _flat_jax_params(jt.state.params, cfg)
    got = pt.optimizer.state_dict()  # also gathers the moments
    for name, p in pt.model.state_dict().items():
        # a key bias's gradient is zero up to rounding noise (the softmax ignores it),
        # which Adam scales up to as much as the learning rate
        tol = cfg.train.learning_rate if name.endswith("attention.key.bias") else 1e-6
        np.testing.assert_allclose(p.numpy(), want[name], rtol=0, atol=tol, err_msg=name)
    assert len(got["adamw"]["state"]) == len(want)


@pytest.mark.parametrize("max_grad_norm", [1e-3, 1e3], ids=["clipped", "unclipped"])
def test_ce_step_equals_jax_trainer(tmp_path, max_grad_norm):
    from colbert_tpu.training import CETrainer as JaxCE
    from tests import test_torch_ce as ce

    cfg = tp(ce.no_dropout(ce.make_cfg(tmp_path, weight_decay=0.5, max_grad_norm=max_grad_norm, learning_rate=1e-5)))
    params = ce._flax_ce_params(cfg)
    j = JaxCE(to_jax_cfg(cfg), ce.jax_tokenizer(cfg), mesh=jax_mesh(), init_params=params)
    from colbert_tpu_torch.training import CETrainer

    t = CETrainer(cfg, ce.port_tokenizer(cfg), device="cpu", init_state_dict=state_dict_from_jax_params(params, cfg.ce_model))
    j._init_state(2)
    t._init_state(2)
    j.np_rng = np.random.default_rng((cfg.ce_train.seed, 0))
    ids, attn, group, teacher = j._build_pairs(ce.make_examples(2, seed=1), "train")
    jteacher = np.zeros((ids.shape[0] // group, group), np.float32)
    j.state, jloss = j._train_step_fn()(j.state, jax.random.fold_in(j.rng, 0), ids, attn, group, jteacher)
    tloss = float(t.compute_grads(ids, attn, group, teacher, 0))
    assert (_grad_norm(t.model) > max_grad_norm) == (max_grad_norm < 1)
    t.optimizer.step()
    assert tloss == pytest.approx(float(jloss), abs=1e-5)
    want = ce._jax_flat(j.state.params, cfg)
    for name, p in t.model.state_dict().items():
        if not ce._zero_gradient(name, cfg):
            np.testing.assert_allclose(p.numpy(), want[name], rtol=0, atol=1e-6, err_msg=name)


# ---- model = 2 against model = 1, K9 on ----

class MaskLog:
    """Every forward dropout call's keep mask, in call order (the plain K9)."""

    def __init__(self, monkeypatch):
        import colbert_tpu_torch.models.bert as bert
        from colbert_tpu_torch.ops.dropout import hw_dropout, mask_bytes

        self.calls = []

        def logged(x, seed, thr, base=0, inner=0, stride=0):
            keep = mask_bytes(x.numel(), seed, None, base, inner, stride).view(x.shape) >= thr
            self.calls.append((keep, inner))
            return hw_dropout(x, seed, thr, base, inner, stride)

        monkeypatch.setattr(bert, "hw_dropout", logged)

    def whole(self):
        """The masks with each site's M position slices put together along
        its split dim (1 of the (B, nh, L, L) probabilities, 2 of the (B, L,
        h) attention output)."""
        out, i = [], 0
        while i < len(self.calls):
            keep, inner = self.calls[i]
            if not inner:
                out.append(keep)
                i += 1
                continue
            parts = [k for k, _ in self.calls[i : i + M]]
            out.append(torch.cat(parts, dim=1 if keep.dim() == 4 else 2))
            i += M
        return out


@pytest.mark.parametrize("site", ["probs", "output", "flash"])
def test_model_2_equals_model_1_with_k9(tmp_path, monkeypatch, site):
    from colbert_tpu_torch.models.sharding import gather_state
    from colbert_tpu_torch.training import ColbertTrainer

    cfg = make_cfg(tmp_path, per_device_batch_size=2)
    cfg.model.hidden_dropout = cfg.model.attention_dropout = 0.1
    cfg.model.dropout_impl = "byte"
    if site == "flash":
        cfg.model.attention_impl = "flash"
        cfg.model.max_position_embeddings = 128
        cfg.tokenizer.doc_maxlen = 128
    else:
        cfg.model.attention_dropout_site = site
    b = _random_batches(cfg, 1, seed=4)[0]
    runs = {}
    for m in (1, M):
        log = MaskLog(monkeypatch)
        t = ColbertTrainer(tp(cfg, m), None, device="cpu", total_steps=2)
        t._init_state(2)
        loss = float(t.compute_grads(b, 3))
        grads = gather_state({n: p.grad for n, p in t.model.named_parameters()}, cfg.model)
        runs[m] = (loss, grads, log.whole(), log.calls)
    (l1, g1, k1, c1), (l2, g2, k2, c2) = runs[1], runs[M]
    assert any(inner for _, inner in c2) and not any(inner for _, inner in c1)
    assert len(k1) == len(k2) == 2 * cfg.model.num_layers * 3 + 2  # query and doc passes, 3 sites a layer + embeddings
    for a, w in zip(k2, k1):
        assert torch.equal(a, w)
    assert abs(l2 - l1) <= TOL_TP * abs(l1)
    largest = max(float(g.abs().max()) for g in g1.values())
    for name, g in g1.items():
        assert float((g2[name] - g).abs().max()) <= 1e-5 * largest, name


# ---- K9's strided counters ----

@pytest.mark.parametrize("kind", ["heads", "columns"])
@pytest.mark.parametrize("row0", [0, 3])
def test_strided_counters_equal_the_whole_mask(kind, row0):
    from colbert_tpu_torch.models.bert import Dropout
    from colbert_tpu_torch.ops.dropout import divisor_magic, hw_dropout_ref, mask_bytes

    B, nh, L, h, seed, thr = 3, 4, 12, 64, 0x1234_5678_9ABC, 51
    full_shape = (B, nh, L, L) if kind == "heads" else (B, L, h)
    dim = 1 if kind == "heads" else 2
    rows = B + row0 + 2  # the data-parallel batch this call's rows sit in
    whole = mask_bytes(rows * int(np.prod(full_shape[1:])), seed).view(rows, *full_shape[1:])[row0 : row0 + B]
    x = torch.randn(full_shape, generator=torch.Generator().manual_seed(0))
    want = hw_dropout_ref(x, seed, thr, row0 * x[0].numel() // 16)
    drop = Dropout(thr / 256, "byte").train()
    for p in range(M):
        part = x.narrow(dim, p * full_shape[dim] // M, full_shape[dim] // M).contiguous()
        inner = int(np.prod(part.shape[dim:]))
        first = row0 * x[0].numel()
        got = mask_bytes(part.numel(), seed, None, (first + p * inner) // 16, inner // 16, M * inner // 16)
        assert torch.equal(got.view(part.shape), whole.narrow(dim, p * part.shape[dim], part.shape[dim]))
        y = drop(part, (seed, row0), (p, M, dim))
        assert torch.equal(y, want.narrow(dim, p * part.shape[dim], part.shape[dim]))
    for d in (1, 2, 3, 24, 55296, 36864, 1 << 20, (1 << 31) - 1):  # the kernel's g div d for g < 2^31
        mul, shr = divisor_magic(d)
        for g in (0, 1, d - 1, d, d + 1, 12345678, (1 << 31) - 1):
            assert (g if d == 1 else (g * mul) >> (32 + shr)) == g // d, (d, g)


def test_a_slice_off_the_counter_groups_is_refused():
    from colbert_tpu_torch.models.bert import Dropout

    x = torch.ones(2, 1, 6, 6)  # 36 elements a run: no whole number of 16-element groups
    with pytest.raises(ValueError, match="counter groups"):
        Dropout(0.1, "byte").train()(x, 5, (0, M, 1))


# ---- checkpoints across meshes, resume ----

@pytest.fixture(scope="module")
def trained_at_2(tmp_path_factory):
    """Port trainers with dropout on (K9 plain), 4 steps, checkpoints at 2 and
    4: one at model 2, and one at model 1 from the same init."""
    from colbert_tpu_torch.tokenization import ColbertTokenizer
    from colbert_tpu_torch.training import ColbertTrainer, RetrievalDataset

    tmp = tmp_path_factory.mktemp("tp_resume")
    cfg = make_cfg(tmp, evals_per_epoch=2)
    tok = ColbertTokenizer(cfg.tokenizer, cfg.multiview)
    ds = RetrievalDataset(make_examples(8))
    out = {}
    for m in (M, 1):
        c = tp(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_dir=str(tmp / f"m{m}"))), m)
        t = ColbertTrainer(c, tok, device="cpu")
        t.train(ds, dev_ds=RetrievalDataset(make_examples(3, seed=9)))
        out[m] = (c, t)
    return tok, ds, out


def test_checkpoints_load_across_meshes(trained_at_2):
    from colbert_tpu_torch.training import ColbertTrainer

    tok, ds, runs = trained_at_2
    (c2, t2), (c1, t1) = runs[M], runs[1]
    assert t2.ckpt.all_steps() == t1.ckpt.all_steps() == [2, 4]
    # the same files: keys, shapes and the optimizer state's layout
    s2, s1 = t2.ckpt.load_train_state(4), t1.ckpt.load_train_state(4)
    a2, a1 = s2["optimizer"]["adamw"], s1["optimizer"]["adamw"]
    assert [g["params"] for g in a2["param_groups"]] == [g["params"] for g in a1["param_groups"]]
    assert sorted(a2["state"]) == sorted(a1["state"])
    for i, e in a1["state"].items():
        assert {k: tuple(v.shape) for k, v in a2["state"][i].items()} == {k: tuple(v.shape) for k, v in e.items()}
    l2 = [s["step_loss"] for s in t2.log.steps]
    l1 = [s["step_loss"] for s in t1.log.steps]
    np.testing.assert_allclose(l2, l1, rtol=TOL_TP)
    # a model = 2 checkpoint resumed at model = 1 and the reverse: the next two steps of the other mesh's run
    for src, dst in ((c2, c1), (c1, c2)):
        d = src.train.checkpoint_dir + f"-to-{dst.mesh.model}"
        shutil.copytree(src.train.checkpoint_dir, d)
        shutil.rmtree(f"{d}/checkpoint-4")
        r = ColbertTrainer(dataclasses.replace(dst, train=dataclasses.replace(dst.train, checkpoint_dir=d)), tok,
                           device="cpu")
        r.train(ds, resume=True)
        assert [s["step"] for s in r.log.steps] == [3, 4]
        np.testing.assert_allclose([s["step_loss"] for s in r.log.steps], l1[2:], rtol=TOL_TP)


def test_resume_at_model_2_is_bit_exact(trained_at_2):
    from colbert_tpu_torch.training import ColbertTrainer

    tok, ds, runs = trained_at_2
    c2, a = runs[M]
    d = c2.train.checkpoint_dir + "-resume"
    shutil.copytree(c2.train.checkpoint_dir, d)
    shutil.rmtree(f"{d}/checkpoint-4")
    b = ColbertTrainer(dataclasses.replace(c2, train=dataclasses.replace(c2.train, checkpoint_dir=d)), tok, device="cpu")
    b.train(ds, resume=True)
    assert [s["step_loss"] for s in b.log.steps] == [s["step_loss"] for s in a.log.steps[2:]]
    wa, wb = a.model.state_dict(), b.model.state_dict()
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert b.optimizer.count == a.optimizer.count == 4


def test_state_dict_is_full_and_a_model_moves_between_groups(tmp_path):
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.models.sharding import model_group, place

    cfg = make_cfg(tmp_path)
    model = ColbertModel(cfg.model, cfg.multiview).eval()
    model.init_weights(torch.Generator().manual_seed(2))
    full = {k: v.clone() for k, v in model.state_dict().items()}
    b = _random_batches(cfg, 1, seed=6)[0]
    run = lambda: model.doc(torch.from_numpy(b.d_ids), torch.from_numpy(b.d_attn))
    with torch.no_grad():
        want = run()
        place(model, GROUP)
        assert any(n.endswith("query.weight.1") for n, _ in model.named_parameters())
        sd = model.state_dict()
        assert list(sd) == list(full) and all(torch.equal(sd[k], full[k]) for k in full)
        model.load_state_dict(full)  # the full layout loads into the shards
        at_2 = run()
        place(model, ["cpu"])
        assert model_group(model) is None and all(torch.equal(model.state_dict()[k], full[k]) for k in full)
        assert torch.equal(run(), want)
    np.testing.assert_allclose(at_2.numpy(), want.numpy(), rtol=0, atol=1e-6)


def test_a_slice_reaches_the_c_function(monkeypatch):
    """The wrapper hands the C function the slice's base, runs, stride and
    the division constants (the CPU has no kernel: the C function is a stand-in)."""
    from colbert_tpu_torch.ops import dropout as dr

    args = []
    monkeypatch.setattr(dr, "_fn", lambda *a: args.append(a) or 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 1234, raising=False)
    before = dr.slice_launches.value
    dr._launch(torch.ones(96, dtype=torch.bfloat16), 99, 26, base=7, inner=3, stride=6)
    assert args[0][2:] == (96, 1, 99, 26, dr.keep_scale(26, torch.bfloat16), 0, -1, 1234, 7, 3, 6,
                           *dr.divisor_magic(3))
    assert dr.slice_launches.value == before + 1
    with pytest.raises(ValueError, match="counter 0 only"):
        dr._launch(torch.ones(96, dtype=torch.bfloat16), 99, 26, route="simple", inner=3, stride=6)

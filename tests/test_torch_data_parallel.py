"""Data-parallel training of the port against one device, on the CPU.

A launch of the port's CLI (``train`` or ``train-ce`` with
``--coordinator/--num-processes 2/--process-id``, ``--device cpu``: two
processes, gloo) at ``per_device_batch_size`` b is held against one
device at the global batch 2b, from the same parameters:

* the JAX trainer's jitted single-device step (dropout off): each step's
  loss within 1e-5 and every parameter within 1e-6 after the last step
  (the limits of ``test_torch_training.py`` / ``test_torch_ce.py``: both
  sides fp32, only the operation order differs; the CE's exactly-zero
  gradients excepted, as there);
* the port's own one-process run (dropout off, and on: K9's counters start
  at each rank's first global row, so the two ranks draw the one device's
  masks): losses within 1e-6 of their size (a few fp32 ulps), parameters
  within 1e-6 (the ranks' gradient halves are summed by the all-reduce,
  not inside one backward; the CE's exactly-zero gradients excepted).

Two retriever steps (the differentiable gather of the docs: each query
against the global batch's docs), also at ``grad_accum_steps=2`` with an
evaluation (K3 over the gathered reps), and one CE step (also at
``grad_accum_steps=2``).  Each launch waits at most
``RUN_TIMEOUT_S`` for its processes, whose process group fails every
collective after ``DIST_TIMEOUT_S``.  Also: a launch of one process
(``--num-processes 1``, in this process) is bit-equal to no launch; the
CLI's checks of the flags and of ``mesh``; the CLI's ``train`` at
``mesh.model=2`` (tensor parallelism) against ``mesh.model=1``; K9's counter base (a rank's
rows draw the one-device masks); the corpus encoder over three positions
of one process and over two ranks writes the one-device part files.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from colbert_tpu_torch.models.convert import reference_state_dict, state_dict_from_jax_params, state_dict_from_reference
from tests.test_torch_training import WORDS, _flat_jax_params, _jax_trainer, make_cfg, make_examples, to_jax_cfg

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tests" / "torch_dp_worker.py"
DIST_TIMEOUT_S = 60
RUN_TIMEOUT_S = 240
TOL_PORT = 1e-6  # losses: relative; parameters: absolute
TOL_JAX_LOSS, TOL_JAX_PARAM = 1e-5, 1e-6
TOL_TP = 1e-5  # tensor-parallel against one position: losses relative, parameters absolute


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, tmp, n=2):
    """Run ``cli.main(args)`` as the ``n`` ranks of a gloo launch, each
    rank's output in ``tmp``; every rank must exit 0."""
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [tmp / f"rank{r}.log" for r in range(n)]
    procs = []
    try:
        for r, log in enumerate(logs):
            with open(log, "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, str(WORKER), str(DIST_TIMEOUT_S), *args, "--device", "cpu", "--coordinator",
                     f"127.0.0.1:{port}", "--num-processes", str(n), "--process-id", str(r)],
                    cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=RUN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log.read_text()[-4000:]}"


def _assert_params_close(got, want, tol, what, skip=lambda name: False):
    for name, w in want.items():
        if not skip(name):
            np.testing.assert_allclose(np.asarray(got[name]), np.asarray(w), rtol=0, atol=tol, err_msg=f"{name} {what}")


def _ckpt_params(path, model_cfg, **kw):
    return {k: v.numpy() for k, v in state_dict_from_reference(path, model_cfg, **kw).items()}


# ---- the retriever ----

def _retriever_setup(tmp, dropout, jax_init=True, accum=1):
    """Configs at b = 2 (two ranks) and 4 (one device), 8 examples (two
    steps), the weights file: the Flax init (plus noise) converted, or
    without ``jax_init`` the port's seeded init (params None)."""
    from colbert_tpu.models import ColbertModel as FlaxColbert
    from colbert_tpu_torch.models.colbert import ColbertModel

    kw = dict(learning_rate=1e-4, weight_decay=0.5, warmup_ratio=0.34, max_grad_norm=0.5, adam_eps=1e-6,
              evals_per_epoch=1, grad_accum_steps=accum)
    cfg = make_cfg(tmp, per_device_batch_size=2, checkpoint_dir=str(tmp / "two"), **kw)
    if not dropout:
        cfg.model.hidden_dropout = cfg.model.attention_dropout = 0.0
    one = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, per_device_batch_size=4,
                                                             checkpoint_dir=str(tmp / "one")))
    params = None
    if jax_init:
        jc = to_jax_cfg(cfg)
        z = jax.numpy.zeros((1, 8), jax.numpy.int32)
        params = FlaxColbert(jc.model, jc.multiview).init(jax.random.PRNGKey(7), z, z + 1, z, z + 1)["params"]
        rng = np.random.default_rng(11)  # non-trivial LayerNorm and bias parameters
        params = jax.tree.map(lambda a: np.asarray(a) + rng.normal(0, 0.05, size=a.shape).astype(np.float32), params)
        sd = state_dict_from_jax_params(params, cfg.model)
    else:
        model = ColbertModel(cfg.model, cfg.multiview)
        model.init_weights(torch.Generator().manual_seed(7))
        sd = model.state_dict()
    weights = tmp / "w.bin"
    torch.save(reference_state_dict(sd, cfg.model), weights)
    data = tmp / "train.json"
    data.write_text(json.dumps(make_examples(8, seed=5)))
    conf = tmp / "two.yaml"
    cfg.to_yaml(conf)
    return cfg, one, params, weights, data, conf


def _log_rows(ckpt_dir, kind):
    rows = [json.loads(line) for line in (Path(ckpt_dir) / "train_log.jsonl").read_text().splitlines()]
    return [r for r in rows if r["kind"] == kind]


def _step_losses(ckpt_dir):
    return [r["step_loss"] for r in _log_rows(ckpt_dir, "step")]


@pytest.mark.parametrize("case", ["dropout_off", "dropout_on", "accum2_eval"])
def test_two_rank_train_equals_one_device(tmp_path, case):
    """"accum2_eval": ``grad_accum_steps=2`` (each global micro-batch's
    in-batch negatives, a query of each rank in each) and an evaluation on
    5 dev examples (two global eval batches of 4, the second padded; K3 on
    the gathered reps): its metrics within 1e-6 of one device's."""
    from colbert_tpu_torch.tokenization import ColbertTokenizer
    from colbert_tpu_torch.training import ColbertTrainer, RetrievalDataset, RetrievalSampler

    dropout, accum = case == "dropout_on", 2 if case == "accum2_eval" else 1
    cfg, one, params, weights, data, conf = _retriever_setup(tmp_path, dropout, accum=accum)
    args = ["train", "--config", str(conf), "--train-data", str(data), "--pretrain", str(weights)]
    dev = None
    if accum > 1:
        (tmp_path / "dev.json").write_text(json.dumps(make_examples(5, seed=9)))
        dev = RetrievalDataset.from_json(str(tmp_path / "dev.json"))
        args += ["--dev-data", str(tmp_path / "dev.json")]
    launch(args, tmp_path)
    two_losses = _step_losses(cfg.train.checkpoint_dir)
    two = _ckpt_params(Path(cfg.train.checkpoint_dir) / "checkpoint-2" / "pytorch.bin", cfg.model)

    tok = ColbertTokenizer(one.tokenizer, one.multiview)
    ds = RetrievalDataset.from_json(str(data))
    port = ColbertTrainer(one, tok, device="cpu",
                          init_state_dict=state_dict_from_reference(str(weights), one.model, require_head=False))
    port.train(ds, dev_ds=dev)
    assert len(two_losses) == 2
    np.testing.assert_allclose(two_losses, [s["step_loss"] for s in port.log.steps], rtol=TOL_PORT, atol=0)
    _assert_params_close(two, {k: v.detach().numpy() for k, v in port.model.state_dict().items()}, TOL_PORT,
                         "against the port's one device")
    if dev is not None:
        evals = _log_rows(cfg.train.checkpoint_dir, "eval")
        assert len(evals) == len(port.log.evals) == 1
        for key, want in port.log.evals[0].items():
            assert evals[0][key] == pytest.approx(want, abs=1e-6), key
    if dropout:
        return
    jt = _jax_trainer(one, params, 2)
    step_fn = jt._train_step_fn()
    for s, b in enumerate(RetrievalSampler(ds, tok, one.train, 4).epoch(0)):
        jt.state, jloss = step_fn(jt.state, jax.random.fold_in(jt.rng, s), *jt._shard_batch(b))
        assert two_losses[s] == pytest.approx(float(jloss), abs=TOL_JAX_LOSS), f"loss at step {s}"
    _assert_params_close(two, _flat_jax_params(jt.state.params, cfg), TOL_JAX_PARAM, "against the JAX step")


# ---- the cross-encoder ----

@pytest.mark.parametrize("case", ["dropout_off", "dropout_on", "accum2"])
def test_two_rank_train_ce_equals_one_device(tmp_path, case):
    """One CE step at global batch 4 against the port's one device and, but
    with dropout on, JAX's; "accum2": ``grad_accum_steps=2``, a question of
    each rank in each global micro-batch."""
    from tests.test_torch_ce import (
        _flax_ce_params, _jax_flat, _trainers, _zero_gradient, make_cfg as ce_cfg, make_examples as ce_examples,
        no_dropout, port_tokenizer,
    )
    from colbert_tpu_torch.training import CETrainer, RetrievalDataset

    exs = ce_examples(4, seed=1)
    data = tmp_path / "ce.json"
    data.write_text(json.dumps(exs))
    cfg = ce_cfg(tmp_path, weight_decay=0.5, max_grad_norm=0.5, learning_rate=1e-5, per_device_batch_size=2,
                 checkpoint_dir=str(tmp_path / "two"), grad_accum_steps=2 if case == "accum2" else 1)
    cfg = cfg if case == "dropout_on" else no_dropout(cfg)
    params = _flax_ce_params(cfg)
    init = state_dict_from_jax_params(params, cfg.ce_model)
    weights = tmp_path / "ce.bin"
    torch.save(reference_state_dict(init, cfg.ce_model, head_bias=True), weights)
    cfg.to_yaml(tmp_path / "two.yaml")
    launch(["train-ce", "--config", str(tmp_path / "two.yaml"), "--train-data", str(data), "--pretrain",
            str(weights)], tmp_path)
    two_loss = [json.loads(x)["loss"] for x in (tmp_path / "two" / "ce_train_steps.jsonl").read_text().splitlines()]
    two = _ckpt_params(tmp_path / "two" / "checkpoint-1" / "pytorch.bin", cfg.ce_model, head_bias=True)

    one = dataclasses.replace(cfg, ce_train=dataclasses.replace(cfg.ce_train, per_device_batch_size=4,
                                                                checkpoint_dir=str(tmp_path / "one")))
    port = CETrainer(one, port_tokenizer(one), device="cpu", init_state_dict=init)
    port_loss = port.train(RetrievalDataset(exs))
    assert len(two_loss) == len(port_loss) == 1
    assert two_loss[0] == pytest.approx(port_loss[0], rel=TOL_PORT)
    _assert_params_close(two, {k: v.detach().numpy() for k, v in port.model.state_dict().items()}, TOL_PORT,
                         "against the port's one device", skip=lambda name: _zero_gradient(name, one))
    if case == "dropout_on":
        return
    j, _ = _trainers(one, jax_init=params)
    j._init_state(1)
    c = one.ce_train
    batch = [exs[i] for i in np.random.default_rng(c.seed).permutation(len(exs))]
    j.np_rng = np.random.default_rng((c.seed, 0))
    ids, attn, group, _ = j._build_pairs(batch, "train")
    j.state, jloss = j._train_step_fn()(j.state, jax.random.fold_in(j.rng, 0), ids, attn, group,
                                       np.zeros((ids.shape[0] // group, group), np.float32))
    assert two_loss[0] == pytest.approx(float(jloss), abs=TOL_JAX_LOSS)
    _assert_params_close(two, _jax_flat(j.state.params, one), TOL_JAX_PARAM, "against the JAX CE step",
                         skip=lambda name: _zero_gradient(name, one))


# ---- a launch of one process; the CLI's checks ----

def test_one_process_launch_is_bit_equal_to_no_launch(tmp_path):
    """``--num-processes 1`` runs the gather and the all-reduce, in this
    process: four steps' losses and parameters bit-equal to the run without
    the flags (dropout on)."""
    from colbert_tpu_torch.cli import main
    from colbert_tpu_torch.parallel.collectives import launched

    cfg, _, _, weights, data, _ = _retriever_setup(tmp_path, dropout=True, jax_init=False)
    runs = {}
    for name, flags in (("plain", []), ("launch", ["--coordinator", f"127.0.0.1:{free_port()}",
                                                    "--num-processes", "1", "--process-id", "0"])):
        run = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_dir=str(tmp_path / name)))
        run.to_yaml(tmp_path / f"{name}.yaml")
        main(["train", "--config", str(tmp_path / f"{name}.yaml"), "--train-data", str(data), "--pretrain",
              str(weights), "--device", "cpu", *flags])
        assert not launched()
        runs[name] = (_step_losses(tmp_path / name),
                      state_dict_from_reference(tmp_path / name / "checkpoint-4" / "pytorch.bin", cfg.model))
    assert runs["plain"][0] == runs["launch"][0]
    for k, v in runs["plain"][1].items():
        assert torch.equal(v, runs["launch"][1][k]), k


@pytest.mark.parametrize("flags, message", [
    (["--coordinator", "127.0.0.1:1"], "--coordinator requires --num-processes and --process-id"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2"], "--coordinator requires --num-processes and"),
])
def test_cli_checks_the_launch_flags(tmp_path, capsys, flags, message):
    """The JAX CLI's check (``colbert_tpu/cli.py:300-303``), before any process group."""
    from colbert_tpu_torch.cli import main

    with pytest.raises(SystemExit):
        main(["train", "--train-data", "t.json", *flags])
    assert message in capsys.readouterr().err


def test_cli_runs_other_subcommands_in_one_process(capsys):
    from colbert_tpu_torch.cli import main

    with pytest.raises(SystemExit):
        main(["build-index", "--coordinator", "127.0.0.1:1", "--num-processes", "2", "--process-id", "0"])
    assert "build-index runs in one process" in capsys.readouterr().err


@pytest.mark.parametrize("overrides, error, match", [
    (["mesh.data=2"], ValueError, "mesh.data=2, but training runs one process a device and this run has 1"),
])
def test_cli_train_checks_the_mesh(tmp_path, overrides, error, match):
    from colbert_tpu_torch.cli import main

    cfg, _, _, weights, data, _ = _retriever_setup(tmp_path, dropout=False, jax_init=False)
    cfg.to_yaml(tmp_path / "c.yaml")
    sets = [x for o in overrides for x in ("--set", o)]
    with pytest.raises(error, match=match):
        main(["train", "--config", str(tmp_path / "c.yaml"), "--train-data", str(data), "--pretrain", str(weights),
              "--device", "cpu", *sets])
    assert not (tmp_path / "two" / "checkpoint-2").exists()


def test_cli_train_at_model_2_equals_model_1(tmp_path):
    """``train --device cpu --set mesh.model=2``: two tensor-parallel
    positions of one process, dropout on (K9's plain version draws each
    position's slice of the one-device masks), against the same command at
    ``mesh.model=1``: each step's loss within ``TOL_PORT`` of its size and
    every parameter of the checkpoint, which has the ``model = 1`` layout,
    within ``TOL_TP`` (the row-parallel products are two half sums added
    after, not one sum: the forward's order of sums changes, and the scores
    are divided by the temperature, 0.05)."""
    from colbert_tpu_torch.cli import main

    _, one, _, weights, data, _ = _retriever_setup(tmp_path, dropout=True, jax_init=False)
    one.to_yaml(tmp_path / "c.yaml")
    dirs = {m: tmp_path / f"model{m}" for m in (1, 2)}
    for m, d in dirs.items():
        main(["train", "--config", str(tmp_path / "c.yaml"), "--train-data", str(data), "--pretrain", str(weights),
              "--device", "cpu", "--set", f"mesh.model={m}", "--set", f"train.checkpoint_dir={d}"])
    losses = {m: _step_losses(d) for m, d in dirs.items()}
    assert len(losses[2]) == 2
    np.testing.assert_allclose(losses[2], losses[1], rtol=TOL_TP, atol=0)
    _assert_params_close(_ckpt_params(dirs[2] / "checkpoint-2" / "pytorch.bin", one.model),
                         _ckpt_params(dirs[1] / "checkpoint-2" / "pytorch.bin", one.model), TOL_TP, "at model 2")


# ---- K9's counter base; the corpus encoder over positions and ranks ----

def test_dropout_rows_draw_the_one_device_masks(monkeypatch):
    """A site's masks over rows ``row0 ..`` (``DropoutRows``) are the rows of
    the one-device batch's masks, forward and backward; a slice that starts
    off K9's 16-element groups is refused; the base reaches the C function."""
    from colbert_tpu_torch.models.bert import Dropout, DropoutRows
    from colbert_tpu_torch.ops import dropout as dr

    site = Dropout(0.1, "byte").train()
    x = torch.randn(6, 3, 16, requires_grad=True)
    gen = lambda: torch.Generator().manual_seed(4)
    whole = site(x, site.seed(gen()))
    whole.backward(torch.ones_like(whole))
    xs = [x.detach()[2 * r : 2 * r + 2].clone().requires_grad_() for r in range(3)]
    parts = [site(xr, site.seed(DropoutRows(gen(), 2 * r))) for r, xr in enumerate(xs)]
    assert torch.equal(torch.cat(parts), whole)
    for p in parts:
        p.backward(torch.ones_like(p))
    assert torch.equal(torch.cat([xr.grad for xr in xs]), x.grad)
    with pytest.raises(ValueError, match="not a multiple of 16"):
        site(torch.randn(2, 3, 5), site.seed(DropoutRows(gen(), 1)))

    args = []
    monkeypatch.setattr(dr, "_fn", lambda *a: args.append(a) or 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda dev: 1234, raising=False)
    dr._launch(torch.ones(40, dtype=torch.bfloat16), 99, 26, base=7)
    assert args[0][2:] == (40, 1, 99, 26, dr.keep_scale(26, torch.bfloat16), 0, -1, 1234, 7, 0, 0, 0, 0)
    with pytest.raises(ValueError, match="counter 0 only"):
        dr._launch(torch.ones(40, dtype=torch.bfloat16), 99, 26, route="simple", base=7)


def _encode_setup(tmp, multiview):
    cfg = make_cfg(tmp)
    cfg.multiview.enabled = multiview
    cfg.index.index_path = str(tmp / "one")
    cfg.index.encode_batch_size = 5
    docs = [f"{w} text about {w} " + "more " * (i % 7) for i, w in enumerate(WORDS * 2)][:11]
    corpus = tmp / "corpus.json"
    corpus.write_text(json.dumps(docs))
    from colbert_tpu_torch.models.colbert import ColbertModel

    model = ColbertModel(cfg.model, cfg.multiview)
    model.init_weights(torch.Generator().manual_seed(1))
    weights = tmp / "w.bin"
    torch.save(reference_state_dict(model.state_dict(), cfg.model), weights)
    cfg.to_yaml(tmp / "c.yaml")
    return cfg, model, docs, corpus, weights


def _parts_equal(a, b):
    from colbert_tpu_torch.indexing.storage import IndexStorage

    sa, sb = IndexStorage(a), IndexStorage(b)
    assert sa.part_ids() == sb.part_ids() and sa.read_meta() == sb.read_meta()
    for p in sa.part_ids():
        assert sa.read_doclens(p) == sb.read_doclens(p)
        np.testing.assert_array_equal(sa.read_part(p), sb.read_part(p))


@pytest.mark.parametrize("multiview", [True, False], ids=["multiview", "ragged"])
def test_encoder_over_positions_and_ranks_writes_the_one_device_parts(tmp_path, multiview):
    """Each batch split over three positions of one process (a replica a
    position), and over the two ranks of a launch (rank 0 writes): the part
    files and ``meta.json`` equal one device's."""
    from colbert_tpu_torch.indexing.encoder import CollectionEncoder
    from colbert_tpu_torch.parallel.mesh import make_mesh
    from colbert_tpu_torch.tokenization import ColbertTokenizer

    cfg, model, docs, corpus, weights = _encode_setup(tmp_path, multiview)
    tok = ColbertTokenizer(cfg.tokenizer, cfg.multiview)
    CollectionEncoder(cfg, tok, model, device="cpu").encode_corpus(docs, str(tmp_path / "one"))
    CollectionEncoder(cfg, tok, model, mesh=make_mesh(devices=["cpu"] * 3)).encode_corpus(docs, str(tmp_path / "three"))
    _parts_equal(tmp_path / "one", tmp_path / "three")
    launch(["encode", "--config", str(tmp_path / "c.yaml"), "--corpus", str(corpus), "--pretrain", str(weights),
            "--set", f"index.index_path={tmp_path / 'ranks'}"], tmp_path)
    _parts_equal(tmp_path / "one", tmp_path / "ranks")

"""The port's package boundary and command line: no module of the port
imports the JAX package (nor jax, flax or transformers), and the CLI
refuses what it cannot do with a clean message."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


def _port_modules():
    import colbert_tpu_torch

    return sorted(m.name for m in pkgutil.walk_packages(colbert_tpu_torch.__path__, "colbert_tpu_torch."))


def test_serve_path_imports_no_jax():
    """Every module of the port, training included, imports nothing of the
    JAX package (nor jax, flax or transformers)."""
    mods = _port_modules()
    assert {"colbert_tpu_torch.training.trainer", "colbert_tpu_torch.ops.dropout",
            "colbert_tpu_torch.ops.maxsim", "colbert_tpu_torch.cli",
            "colbert_tpu_torch.ops.kmeans", "colbert_tpu_torch.ops.sq", "colbert_tpu_torch.ops.ivf",
            "colbert_tpu_torch.ops.sq_probe_batched", "colbert_tpu_torch.ops.rerank",
            "colbert_tpu_torch.indexing.builder", "colbert_tpu_torch.ops.pq", "colbert_tpu_torch.ops.pq4",
            "colbert_tpu_torch.ops.sq_probe"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('colbert_tpu', 'jax', 'flax', 'transformers'))\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_package_source_never_imports_jax():
    for path in [*(REPO / "colbert_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]:
        for line in path.read_text(encoding="utf-8").splitlines():
            s = line.strip()
            assert not s.startswith(("import jax", "from jax", "import flax", "from flax")), (path, line)
            assert not s.startswith(("import colbert_tpu.", "from colbert_tpu.", "import colbert_tpu ",
                                     "from colbert_tpu ")), (path, line)
            assert s != "import colbert_tpu", (path, line)


@pytest.mark.parametrize("cmd", ["train-ce", "mine"])
def test_cli_names_unported_subcommands(cmd, tmp_path, capsys):
    """``train-ce`` and ``mine`` are ported, and so is the JAX CLI's launch
    (``--coordinator/--num-processes/--process-id``): its check of the
    flags holds before any process group, and ``mine`` runs in one process."""
    from colbert_tpu_torch.cli import main

    data = ["--train-data", "t.json"] if cmd == "train-ce" else [
        "--corpus", "c.json", "--eval-data", "e.json", "--out", str(tmp_path / "o.json")]
    with pytest.raises(SystemExit):
        main([cmd, *data, "--coordinator", "localhost:1234", "--process-id", "0"])
    assert "--coordinator requires --num-processes and --process-id" in capsys.readouterr().err
    if cmd == "mine":
        with pytest.raises(SystemExit):
            main([cmd, *data, "--coordinator", "localhost:1234", "--num-processes", "2", "--process-id", "0"])
        assert "mine runs in one process" in capsys.readouterr().err
    assert not (tmp_path / "o.json").exists()


def test_cli_help_names_build_index(capsys):
    from colbert_tpu_torch.cli import main

    with pytest.raises(SystemExit):
        main(["--help"])
    out = capsys.readouterr().out
    assert "build-index" in out and "IVF index" in out


def test_cli_requires_pretrain(tmp_path):
    from colbert_tpu_torch.cli import main

    corpus = tmp_path / "c.json"
    corpus.write_text('["a"]')
    with pytest.raises(SystemExit, match="no --pretrain <pytorch.bin> and no checkpoint under"):
        main(["encode", "--corpus", str(corpus), "--device", "cpu",
              "--set", f"tokenizer.vocab_path={tmp_path / 'missing.txt'}",
              "--set", f"train.checkpoint_dir={tmp_path / 'ckpt'}"])


def test_cli_encode_then_evaluate(tmp_path, capsys):
    """encode -> evaluate (local) through the CLI, on the CPU, at a tiny size."""
    import json

    import torch

    from colbert_tpu_torch.cli import main
    from colbert_tpu_torch.config import (
        ColbertConfig, IndexConfig, ModelConfig, MultiviewConfig, ServeConfig, TokenizerConfig,
    )
    from colbert_tpu_torch.tokenization.vocab import build_vocab, write_vocab
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.models.convert import reference_state_dict

    docs = [f"第{i}篇 文档 topic{i % 3} words, more." for i in range(12)]
    corpus = tmp_path / "corpus.json"
    corpus.write_text(json.dumps(docs, ensure_ascii=False), encoding="utf-8")
    evals = tmp_path / "eval.json"
    evals.write_text(json.dumps([{"question": docs[4], "positive_ctxs": [docs[4]]}], ensure_ascii=False),
                     encoding="utf-8")
    cfg = ColbertConfig(
        model=ModelConfig(vocab_size=512, hidden_size=32, num_layers=1, num_heads=2,
                          intermediate_size=64, max_position_embeddings=64, dim=64, dtype="float32"),
        multiview=MultiviewConfig(enabled=True, q_view=4, d_view=4),
        tokenizer=TokenizerConfig(vocab_path=write_vocab(build_vocab(docs), tmp_path / "vocab.txt"),
                                  query_maxlen=16, doc_maxlen=32),
        index=IndexConfig(index_path=str(tmp_path / "index"), num_parts=2),
        serve=ServeConfig(mode="flat", topk=5, query_batch_size=4),
    )
    conf = tmp_path / "conf.yaml"
    cfg.to_yaml(conf)
    model = ColbertModel(cfg.model, cfg.multiview)
    model.init_weights(torch.Generator().manual_seed(0))
    weights = tmp_path / "pytorch.bin"
    torch.save(reference_state_dict(model.state_dict(), cfg.model), weights)
    common = ["--config", str(conf), "--pretrain", str(weights), "--device", "cpu"]

    main(["encode", "--corpus", str(corpus), *common])
    assert (tmp_path / "index" / "meta.json").exists()
    capsys.readouterr()
    main(["evaluate", "--eval-data", str(evals), "--corpus", str(corpus), "--topk", "5", *common])
    metrics = json.loads(capsys.readouterr().out)
    assert metrics["recall@50"] == 1.0  # a question equal to its passage finds it

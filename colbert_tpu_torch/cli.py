"""Command line of the port: the ``train``, ``encode``, ``build-index``,
``serve`` and ``evaluate`` subcommands of ``colbert_tpu/cli.py``.

    python -m colbert_tpu_torch.cli train       --config conf.yaml --train-data t.json [--dev-data d.json] [--resume] [--pretrain pytorch.bin]
    python -m colbert_tpu_torch.cli encode      --config conf.yaml --corpus corpus.json [--checkpoint-step N | --pretrain pytorch.bin]
    python -m colbert_tpu_torch.cli build-index --config conf.yaml
    python -m colbert_tpu_torch.cli serve       --config conf.yaml --corpus corpus.json
    python -m colbert_tpu_torch.cli evaluate    --config conf.yaml --eval-data dev.json --remote

``build-index`` writes the IVF index (``index.codec`` "pq", the default,
"pq4" or "sq") over the encoded parts; ``serve`` and ``evaluate`` serve it
with ``serve.mode=ann`` (the config default) or serve the parts alone with
``serve.mode=flat``.

Retriever parameters resolve as the JAX CLI's ``_retriever_params`` does:
``--pretrain`` (a ``pytorch.bin`` in the reference layout, ``model.*`` +
``linear.weight``, as ``colbert_params_to_torch_state_dict`` exports a JAX
checkpoint), else checkpoint ``--checkpoint-step`` (default: the latest)
under ``train.checkpoint_dir``, else a clean error.  ``train --pretrain``
also takes a bare BERT and starts the projection head fresh.  Overrides:
repeated ``--set key=value`` with dotted keys.  Everything runs on
``--device`` (default ``cuda``; the CPU only when asked for).
"""

from __future__ import annotations

import argparse
import ast
import json
from typing import Any, Dict, List, Optional

from colbert_tpu_torch.config import ColbertConfig, load_config
from colbert_tpu_torch.utils.io import dump_json, load_json

_NOT_PORTED = ("train-ce", "mine")


def _parse_overrides(pairs: List[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for p in pairs:
        k, _, v = p.partition("=")
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def _load_cfg(args) -> ColbertConfig:
    return load_config(args.config, _parse_overrides(args.set or []))


def _tokenizer(cfg: ColbertConfig):
    from colbert_tpu_torch.tokenization import ColbertTokenizer

    return ColbertTokenizer(cfg.tokenizer, cfg.multiview)


def _load_corpus(path: str) -> List[str]:
    if path.endswith(".json"):
        return load_json(path)
    from colbert_tpu_torch.evaluation.dureader import load_tsv_corpus

    return load_tsv_corpus([path])


def _retriever_state_dict(cfg: ColbertConfig, checkpoint_step: Optional[int], pretrain: Optional[str]):
    """``--pretrain`` > checkpoint (``--checkpoint-step`` or the latest) > error."""
    from colbert_tpu_torch.models.convert import state_dict_from_reference
    from colbert_tpu_torch.training.checkpoint import CheckpointManager

    if pretrain:
        return state_dict_from_reference(pretrain, cfg.model)
    ckpt = CheckpointManager(cfg.train.checkpoint_dir)
    step = checkpoint_step if checkpoint_step is not None else ckpt.latest_step()
    if step is None or not ckpt.params_path(step).exists():
        which = "checkpoint" if checkpoint_step is None else f"checkpoint {checkpoint_step}"
        raise SystemExit(
            f"no retriever parameters: no --pretrain <pytorch.bin> and no {which} under {ckpt.dir} "
            "(run `train` first, or export a JAX checkpoint with "
            "colbert_tpu.models.convert.colbert_params_to_torch_state_dict)"
        )
    return state_dict_from_reference(ckpt.params_path(step), cfg.model)


def _model(cfg: ColbertConfig, args):
    from colbert_tpu_torch.models.colbert import ColbertModel

    model = ColbertModel(cfg.model, cfg.multiview)
    model.load_state_dict(_retriever_state_dict(cfg, args.checkpoint_step, args.pretrain))
    return model


def cmd_train(args) -> None:
    cfg = _load_cfg(args)
    from colbert_tpu_torch.models.convert import state_dict_from_reference
    from colbert_tpu_torch.training import ColbertTrainer, RetrievalDataset

    init = state_dict_from_reference(args.pretrain, cfg.model, require_head=False) if args.pretrain else None
    trainer = ColbertTrainer(cfg, _tokenizer(cfg), device=args.device, init_state_dict=init)
    train_ds = RetrievalDataset.from_json(args.train_data)
    dev_ds = RetrievalDataset.from_json(args.dev_data) if args.dev_data else None
    trainer.train(train_ds, dev_ds=dev_ds, resume=args.resume)


def cmd_encode(args) -> None:
    cfg = _load_cfg(args)
    from colbert_tpu_torch.indexing.encoder import CollectionEncoder

    model = _model(cfg, args)
    encoder = CollectionEncoder(cfg, _tokenizer(cfg), model, device=args.device)
    encoder.encode_corpus(_load_corpus(args.corpus), cfg.index.index_path)


def cmd_build_index(args) -> None:
    cfg = _load_cfg(args)
    from colbert_tpu_torch.indexing.builder import IndexBuilder
    from colbert_tpu_torch.indexing.storage import IndexStorage

    IndexBuilder(cfg, IndexStorage(cfg.index.index_path), device=args.device).build()


def make_service(cfg: ColbertConfig, args):
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.ranking.searcher import ColbertSearcher
    from colbert_tpu_torch.serving.server import RetrievalService

    model = _model(cfg, args)
    searcher = ColbertSearcher(
        cfg, _tokenizer(cfg), model, IndexStorage(cfg.index.index_path), device=args.device
    )
    return RetrievalService(searcher, _load_corpus(args.corpus), cfg)


def cmd_serve(args) -> None:
    cfg = _load_cfg(args)
    from colbert_tpu_torch.serving.server import RetrievalServer

    RetrievalServer(make_service(cfg, args)).serve_forever()


def cmd_evaluate(args) -> None:
    cfg = _load_cfg(args)
    from colbert_tpu_torch.serving.server import evaluate_retrieval

    if not args.remote and not args.corpus:
        raise SystemExit(
            "evaluate: --corpus is required when running locally "
            "(pass --remote to evaluate against a running server instead)"
        )
    eval_data = load_json(args.eval_data)
    if args.remote:
        from colbert_tpu_torch.serving.server import RetrievalClient

        client = RetrievalClient(cfg.serve.host, cfg.serve.port, cfg.serve.authkey.encode())
        retrieve = lambda qs, k: client.retrieve(
            qs, topk=k, depth=cfg.serve.candidate_depth, nprobe=cfg.serve.nprobe
        )
    else:
        service = make_service(cfg, args)
        retrieve = lambda qs, k: service.retrieve(qs, topk=k)
    metrics = evaluate_retrieval(retrieve, eval_data, topk=args.topk)
    print(json.dumps(metrics, indent=2))
    if args.out:
        dump_json(metrics, args.out, indent=2)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="colbert_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, corpus=False, data=False):
        p.add_argument("--config", default=None)
        p.add_argument("--set", action="append", metavar="KEY=VALUE")
        p.add_argument("--pretrain", default=None,
                       help="reference-layout pytorch.bin (model.* + linear.weight)")
        p.add_argument("--checkpoint-step", type=int, default=None)
        p.add_argument("--device", default="cuda", help="torch device (default cuda)")
        if corpus:
            p.add_argument("--corpus", required=True)
        if data:
            p.add_argument("--eval-data", required=True)

    p = sub.add_parser("train"); common(p)
    p.add_argument("--train-data", required=True); p.add_argument("--dev-data", default=None)
    p.add_argument("--resume", action="store_true"); p.set_defaults(fn=cmd_train)
    p = sub.add_parser("encode"); common(p, corpus=True); p.set_defaults(fn=cmd_encode)
    p = sub.add_parser("build-index", help="IVF index (pq, pq4 or sq codec) over the encoded parts")
    common(p); p.set_defaults(fn=cmd_build_index)
    p = sub.add_parser("serve"); common(p, corpus=True); p.set_defaults(fn=cmd_serve)
    p = sub.add_parser("evaluate"); common(p, data=True)
    p.add_argument("--corpus", default=None)
    p.add_argument("--remote", action="store_true")
    p.add_argument("--topk", type=int, default=100)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_evaluate)
    for name in _NOT_PORTED:
        p = sub.add_parser(name, help="not yet ported (use python -m colbert_tpu.cli)")
        p.set_defaults(fn=None)

    args, rest = ap.parse_known_args(argv)
    if args.fn is None:
        raise SystemExit(
            f"{args.cmd}: not yet ported to colbert_tpu_torch (see ROADMAP.md); "
            "use python -m colbert_tpu.cli"
        )
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    args.fn(args)


if __name__ == "__main__":
    main()

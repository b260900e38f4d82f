"""Command line of the port: the ``encode``, ``serve`` and ``evaluate``
subcommands of ``colbert_tpu/cli.py``.

    python -m colbert_tpu_torch.cli encode   --config conf.yaml --corpus corpus.json --pretrain pytorch.bin
    python -m colbert_tpu_torch.cli serve    --config conf.yaml --corpus corpus.json --pretrain pytorch.bin
    python -m colbert_tpu_torch.cli evaluate --config conf.yaml --eval-data dev.json --remote

Parameters come from ``--pretrain``: a ``pytorch.bin`` in the reference
layout (``model.*`` + ``linear.weight``), as
``colbert_tpu.models.convert.colbert_params_to_torch_state_dict`` exports a
JAX checkpoint.  Overrides: repeated ``--set key=value`` with dotted keys.
The model and the flat scan run on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import ast
import json
from typing import Any, Dict, List, Optional

from colbert_tpu.config import ColbertConfig, load_config
from colbert_tpu.utils.io import dump_json, load_json

_NOT_PORTED = ("train", "train-ce", "build-index", "mine")


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
    from colbert_tpu.evaluation.dureader import load_tsv_corpus

    return load_tsv_corpus([path])


def _model(cfg: ColbertConfig, pretrain: Optional[str]):
    """The retriever from a reference-layout ``pytorch.bin``."""
    if not pretrain:
        raise SystemExit(
            "--pretrain <pytorch.bin> is required: the port reads the reference "
            "pytorch.bin layout; export a JAX checkpoint with "
            "colbert_tpu.models.convert.colbert_params_to_torch_state_dict "
            "(orbax checkpoints need jax)"
        )
    from colbert_tpu_torch.models.colbert import ColbertModel
    from colbert_tpu_torch.models.convert import state_dict_from_reference

    model = ColbertModel(cfg.model, cfg.multiview)
    model.load_state_dict(state_dict_from_reference(pretrain, cfg.model))
    return model


def cmd_encode(args) -> None:
    cfg = _load_cfg(args)
    from colbert_tpu_torch.indexing.encoder import CollectionEncoder

    model = _model(cfg, args.pretrain)
    encoder = CollectionEncoder(cfg, _tokenizer(cfg), model, device=args.device)
    encoder.encode_corpus(_load_corpus(args.corpus), cfg.index.index_path)


def make_service(cfg: ColbertConfig, args):
    from colbert_tpu_torch.indexing.storage import IndexStorage
    from colbert_tpu_torch.ranking.searcher import ColbertSearcher
    from colbert_tpu_torch.serving.server import RetrievalService

    model = _model(cfg, args.pretrain)
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
        p.add_argument("--device", default="cuda", help="torch device for the model and the scan")
        if corpus:
            p.add_argument("--corpus", required=True)
        if data:
            p.add_argument("--eval-data", required=True)

    p = sub.add_parser("encode"); common(p, corpus=True); p.set_defaults(fn=cmd_encode)
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

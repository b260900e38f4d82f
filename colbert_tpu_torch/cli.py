"""Command line of the port: every subcommand of ``colbert_tpu/cli.py``.

    python -m colbert_tpu_torch.cli train       --config conf.yaml --train-data t.json [--dev-data d.json] [--resume] [--pretrain pytorch.bin]
    python -m colbert_tpu_torch.cli train-ce    --config conf.yaml --train-data t.json [--dev-data d.json] [--resume] [--pretrain ce.bin]
    python -m colbert_tpu_torch.cli encode      --config conf.yaml --corpus corpus.json [--checkpoint-step N | --pretrain pytorch.bin]
    python -m colbert_tpu_torch.cli build-index --config conf.yaml
    python -m colbert_tpu_torch.cli serve       --config conf.yaml --corpus corpus.json
    python -m colbert_tpu_torch.cli evaluate    --config conf.yaml --eval-data dev.json --remote [--rerank-ce]
    python -m colbert_tpu_torch.cli mine        --config conf.yaml --corpus corpus.json --eval-data train.json --out out.json [--distill-out d.json]

``build-index`` writes the IVF index (``index.codec`` "pq", the default,
"pq4" or "sq") over the encoded parts; ``serve`` and ``evaluate`` serve it
with ``serve.mode=ann`` (the config default) or serve the parts alone with
``serve.mode=flat``.  ``mine`` retrieves the top ``--topk`` passages of
each question and writes ``--keep-old`` old negatives plus the fresh ones
(``gen_iter_train_dev``), and with ``--distill-out`` the retriever's scored
top windows (``gen_distill_data``); ``train-ce`` trains the cross-encoder
on such a file; ``evaluate --rerank-ce`` reranks the top
``ce_train.eval_topk`` of every question with the latest CE checkpoint.

Retriever parameters resolve as the JAX CLI's ``_retriever_params`` does:
``--pretrain`` (a ``pytorch.bin`` in the reference layout, ``model.*`` +
``linear.weight``, as ``colbert_params_to_torch_state_dict`` exports a JAX
checkpoint), else checkpoint ``--checkpoint-step`` (default: the latest)
under ``train.checkpoint_dir``, else a clean error.  ``train --pretrain``
also takes a bare BERT and starts the projection head fresh; so does
``train-ce --pretrain`` (a CE ``pytorch.bin`` adds ``linear.bias``), and
without it ``ce_train.init_from_retriever`` grafts the latest retriever
checkpoint's BERT into the CE.  Overrides: repeated ``--set key=value``
with dotted keys.  Everything runs on ``--device`` (default ``cuda``; the
CPU only when asked for).

Several GPUs (the ``mesh`` section: ``data`` positions, -1 for every
device, each of ``model`` positions):

* ``mesh.model`` > 1 (tensor parallelism, ``models/sharding.py``) shards
  the retriever or the CE of every subcommand over ``model`` positions of
  one process: a bare ``--device cuda`` takes that many GPUs, a named
  device (``--device cpu``, ``--device cuda:0``) holds every position;
* ``encode`` with ``--device cuda`` splits each batch over ``mesh.data``
  GPUs (model groups) of the one process, a model replica each;
* a launch runs the same command once a GPU, with ``--coordinator
  host:port`` (rank 0's address), ``--num-processes N`` and a distinct
  ``--process-id`` (the reference's ``torch.distributed.launch``): rank r
  takes ``mesh.model`` GPUs from ``cuda:{r * model % device_count}`` (NCCL;
  gloo with ``--device cpu``), so the launch runs ``data x model`` GPUs.
  ``train`` and ``train-ce`` then run data-parallel over the global batch
  of ``per_device_batch_size x N``, ``encode`` splits each batch over the
  ranks, and rank 0 alone writes.  The other subcommands run in one
  process (``ranking/sharded.py``'s corpus-sharded searcher is a library
  API, as in the JAX package).
"""

from __future__ import annotations

import argparse
import ast
import json
from typing import Any, Dict, List, Optional

from colbert_tpu_torch.config import ColbertConfig, load_config
from colbert_tpu_torch.utils.io import dump_json, load_json
from colbert_tpu_torch.utils.logging import get_logger

logger = get_logger("cli")


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


def _mesh(cfg: ColbertConfig, args, data: int = 1):
    """The mesh a subcommand runs on (``parallel/mesh.py``): under a launch,
    this rank's data position (its ``mesh.model`` GPUs from the one it was
    given, or the CPU); else ``data`` positions (``encode``: ``mesh.data``)
    of ``mesh.model`` from ``--device`` (``device_mesh``)."""
    from colbert_tpu_torch.parallel.collectives import launched, world
    from colbert_tpu_torch.parallel.mesh import device_mesh, make_mesh

    model = cfg.mesh.model
    if launched():
        if cfg.mesh.data not in (-1, world()[1]):
            raise SystemExit(f"mesh.data={cfg.mesh.data} but the launch has {world()[1]} processes")
        import torch

        dev = torch.device(args.device)
        return make_mesh(1, model) if dev.type == "cuda" else device_mesh(dev, 1, model)
    return device_mesh(args.device, data, model)


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
    trainer = ColbertTrainer(cfg, _tokenizer(cfg), device=args.device, init_state_dict=init, mesh=_mesh(cfg, args))
    train_ds = RetrievalDataset.from_json(args.train_data)
    dev_ds = RetrievalDataset.from_json(args.dev_data) if args.dev_data else None
    trainer.train(train_ds, dev_ds=dev_ds, resume=args.resume)


def _ce_init_state_dict(cfg: ColbertConfig, pretrain: Optional[str]):
    """The CE's starting parameters: ``--pretrain`` (a CE ``pytorch.bin`` or a
    bare BERT), else with ``ce_train.init_from_retriever`` the latest
    retriever checkpoint's BERT (the no-pretraining analogue of the
    reference's macbert backbone), else None (a fresh init).  What it lacks
    keeps the fresh init."""
    from colbert_tpu_torch.models.convert import state_dict_from_reference

    if pretrain:
        return state_dict_from_reference(pretrain, cfg.ce_model, require_head=False, head_bias=True)
    if cfg.ce_train.init_from_retriever:
        retr = _retriever_state_dict(cfg, None, None)
        return {k: v for k, v in retr.items() if k.startswith("bert.")}
    return None


def cmd_train_ce(args) -> None:
    cfg = _load_cfg(args)
    from colbert_tpu_torch.training import CETrainer, RetrievalDataset

    trainer = CETrainer(cfg, _tokenizer(cfg), device=args.device,
                        init_state_dict=_ce_init_state_dict(cfg, args.pretrain), mesh=_mesh(cfg, args))
    train_ds = RetrievalDataset.from_json(args.train_data)
    dev_ds = RetrievalDataset.from_json(args.dev_data) if args.dev_data else None
    trainer.train(train_ds, dev_ds=dev_ds, resume=args.resume)


def cmd_encode(args) -> None:
    cfg = _load_cfg(args)
    from colbert_tpu_torch.indexing.encoder import CollectionEncoder

    model = _model(cfg, args)
    encoder = CollectionEncoder(cfg, _tokenizer(cfg), model, mesh=_mesh(cfg, args, data=cfg.mesh.data))
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
    if args.rerank_ce:
        retrieve = _reranked(cfg, args.device, retrieve)
    metrics = evaluate_retrieval(retrieve, eval_data, topk=args.topk)
    print(json.dumps(metrics, indent=2))
    if args.out:
        dump_json(metrics, args.out, indent=2)


def _reranked(cfg: ColbertConfig, device, base_retrieve):
    """Two stages: retrieve, then the cross-encoder reorders each question's
    top ``ce_train.eval_topk`` (reference stage 6, ``ce_trainer.py:97-123``)."""
    from colbert_tpu_torch.training import CETrainer

    ce = CETrainer(cfg, _tokenizer(cfg), device=device)
    ce.load_for_inference()
    top = cfg.ce_train.eval_topk

    def retrieve(qs, k):
        rows = base_retrieve(qs, max(k, top))
        out = []
        for q, row in zip(qs, rows):
            order = ce.rerank(q, [t for _, _, t in row][:top])
            out.append(([row[i] for i in order] + row[top:])[:k])
        return out

    return retrieve


def cmd_mine(args) -> None:
    """Iterative hard-negative mining (``gen_iter_colbert_train_dev`` parity).
    ``--distill-out`` also writes the CE distillation data of the same
    retrieval pass (``gen_distill_data``)."""
    cfg = _load_cfg(args)
    from colbert_tpu_torch.evaluation import gen_distill_data, gen_iter_train_dev

    service = make_service(cfg, args)
    data = load_json(args.eval_data)
    res = service.retrieve([t["question"] for t in data], topk=args.topk)
    for t, r in zip(data, res):
        t["res"] = r
    dump_json(gen_iter_train_dev(data, keep_old=args.keep_old, top=args.topk), args.out)
    logger.info("wrote %s", args.out)
    if args.distill_out:
        dist = gen_distill_data(data, group=cfg.ce_train.distill_group)
        dump_json(dist, args.distill_out)
        logger.info(
            "wrote %s (%d/%d questions kept: positive inside the top-%d window)",
            args.distill_out, len(dist), len(data), cfg.ce_train.distill_group,
        )


_LAUNCHED = ("encode", "train", "train-ce")  # the subcommands a launch of several processes runs


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(prog="colbert_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, corpus=False, data=False):
        p.add_argument("--config", default=None)
        p.add_argument("--set", action="append", metavar="KEY=VALUE")
        p.add_argument("--pretrain", default=None,
                       help="reference-layout pytorch.bin (model.* + linear.*): the retriever's; train-ce's own CE")
        p.add_argument("--checkpoint-step", type=int, default=None)
        p.add_argument("--device", default="cuda",
                       help="torch device (default cuda: mesh.model GPUs a model group, encode mesh.data groups; "
                            "a named device, e.g. cpu or cuda:0, holds every position)")
        # a launch: the same command once a GPU, each with its --process-id
        # (the reference's torch.distributed.launch, eval.sh:13)
        p.add_argument("--coordinator", default=None,
                       help="host:port of rank 0 (a launch: one process a GPU; NCCL, or gloo with --device cpu)")
        p.add_argument("--num-processes", type=int, default=None, help="processes of the launch")
        p.add_argument("--process-id", type=int, default=None, help="this process's rank")
        if corpus:
            p.add_argument("--corpus", required=True)
        if data:
            p.add_argument("--eval-data", required=True)

    p = sub.add_parser("train"); common(p)
    p.add_argument("--train-data", required=True); p.add_argument("--dev-data", default=None)
    p.add_argument("--resume", action="store_true"); p.set_defaults(fn=cmd_train)
    p = sub.add_parser("train-ce", help="the cross-encoder reranker"); common(p)
    p.add_argument("--train-data", required=True); p.add_argument("--dev-data", default=None)
    p.add_argument("--resume", action="store_true"); p.set_defaults(fn=cmd_train_ce)
    p = sub.add_parser("encode"); common(p, corpus=True); p.set_defaults(fn=cmd_encode)
    p = sub.add_parser("build-index", help="IVF index (pq, pq4 or sq codec) over the encoded parts")
    common(p); p.set_defaults(fn=cmd_build_index)
    p = sub.add_parser("serve"); common(p, corpus=True); p.set_defaults(fn=cmd_serve)
    p = sub.add_parser("evaluate"); common(p, data=True)
    p.add_argument("--corpus", default=None)
    p.add_argument("--remote", action="store_true")
    p.add_argument("--rerank-ce", action="store_true", help="apply the cross-encoder second stage")
    p.add_argument("--topk", type=int, default=100)
    p.add_argument("--out", default=None)
    p.set_defaults(fn=cmd_evaluate)
    p = sub.add_parser("mine", help="hard-negative mining"); common(p, corpus=True, data=True)
    p.add_argument("--out", required=True)
    p.add_argument("--topk", type=int, default=50)
    p.add_argument("--keep-old", type=int, default=10)
    p.add_argument("--distill-out", default=None,
                   help="also write CE distillation data (teacher-scored windows)")
    p.set_defaults(fn=cmd_mine)

    args = ap.parse_args(argv)
    if getattr(args, "coordinator", None):
        if args.num_processes is None or args.process_id is None:
            ap.error("--coordinator requires --num-processes and --process-id")
        if args.num_processes > 1 and args.cmd not in _LAUNCHED:
            ap.error(f"{args.cmd} runs in one process; a launch of {args.num_processes} runs "
                     f"{', '.join(sorted(_LAUNCHED))}")
        from colbert_tpu_torch.parallel.mesh import init_distributed

        # before any device use: joins the process group and picks this rank's device
        args.device = str(init_distributed(args.coordinator, args.num_processes, args.process_id,
                                           device=args.device, model=_load_cfg(args).mesh.model))
    try:
        args.fn(args)
    finally:
        if getattr(args, "coordinator", None):
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()

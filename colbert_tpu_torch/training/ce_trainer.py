"""Cross-encoder reranker trainer (one device, or data-parallel) and reranking: counterpart of
``colbert_tpu/training/ce_trainer.py:37-343`` (reference CE flow,
``colbert/modeling/ce_model.py:56-101``, ``colbert/training/ce_trainer.py:21-123``).

* Pairs (``_build_pairs``, host numpy): train draws 1 random positive and
  ``neg_num`` negatives without replacement from
  ``hard_negative_ctxs[neg_pool_lo:neg_pool_hi]``; dev takes the first
  positive and the ``2 * neg_num`` leading negatives; test takes the top
  ``eval_topk`` retrieval results; distill takes the retriever's scored
  window (``res_scored``), padded with ``-1e4`` teacher scores.  The draws
  are the JAX package's own: ``np.random.default_rng((seed, step))`` a step
  and ``default_rng(seed + epoch)`` for the order, so both packages build
  identical pairs.
* Train step: NLL over each question's (1 + neg) row at column 0, at
  temperature ``score_temperature``; with ``distill_weight`` w > 0,
  ``(1 - w) * NLL + w * KL(teacher / distill_temperature)``.  Dropout (K9
  for the "byte"/"hw" impls, forward and backward) draws from a generator
  seeded by ``(seed, step)``; ``grad_accum_steps`` splits the batch into
  question-aligned micro-batches (``(seed, step, 100 + i)``) and averages
  their gradients, which leaves the loss unchanged: each question's softmax
  is its own row.
* Optimizer: as the JAX CE builds it, a default ``TrainConfig`` with only
  ``learning_rate``, ``weight_decay`` and ``max_grad_norm`` from
  ``ce_train`` (so the warmup ratio and Adam's betas and eps are
  ``TrainConfig``'s defaults), weight decay masked off ``linear.bias``, the
  biases and the LayerNorms.
* ``train``: an evaluation (dev MRR) and a checkpoint every
  ``steps_per_epoch // evals_per_epoch`` steps, the NaN guard, bit-exact
  resume, a final save, ``ce_train_log.jsonl`` (the JAX rows: step, loss,
  dev_mrr at each evaluation) and ``ce_train_steps.jsonl`` (step, loss and
  wall seconds of every step).  Checkpoints hold ``pytorch.bin`` in the
  reference CE layout, which ``colbert_tpu.models.convert.ce_params_from_torch``
  reads.
* ``rerank``: a question's candidates scored in padded batches of 128,
  ordered by ``np.argsort(-scores)`` on the host, as the JAX package does.
* Data parallelism (JAX ``:41-67, 215-230``), as the retriever trainer's:
  every rank builds the pairs of the global batch (``per_device_batch_size
  x world`` questions) and takes its questions of each micro-batch; each
  question's softmax is its own row, so nothing is gathered: the per-rank
  mean loss and the rank-averaged gradients are the global batch's.  K9's
  counters start at the rank's first pair row.  Every rank evaluates the
  whole dev set; rank 0 alone writes checkpoints and logs.
* Tensor parallelism (``mesh.model > 1``, JAX ``:46-67``), as the
  retriever trainer's: the CE sharded over the rank's model group, its
  logits back on the first device, checkpoints in the full layout.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from colbert_tpu_torch.config import ColbertConfig, TrainConfig
from colbert_tpu_torch.models.bert import DropoutRows
from colbert_tpu_torch.models.ce import CrossEncoderModel
from colbert_tpu_torch.models.convert import reference_state_dict, state_dict_from_reference
from colbert_tpu_torch.models.sharding import place
from colbert_tpu_torch.parallel.mesh import Mesh, device_mesh
from colbert_tpu_torch.tokenization import ColbertTokenizer
from colbert_tpu_torch.training.checkpoint import CheckpointManager
from colbert_tpu_torch.training.dataset import RetrievalDataset
from colbert_tpu_torch.training.losses import biencoder_nll_loss, kl_loss
from colbert_tpu_torch.training.train_state import Optimizer
from colbert_tpu_torch.parallel.collectives import average_grads, barrier, mean_over_ranks
from colbert_tpu_torch.training.trainer import _merge_params, data_parallel_world, fold_seed, rank_rows
from colbert_tpu_torch.utils.io import dump_jsonl
from colbert_tpu_torch.utils.logging import get_logger

logger = get_logger("ce_trainer")


class CETrainer:
    def __init__(
        self,
        cfg: ColbertConfig,
        tokenizer: ColbertTokenizer,
        device: str | torch.device = "cuda",
        init_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        mesh: Optional[Mesh] = None,
    ):
        """``mesh``: this process's data position and its model group
        (default: ``device`` at ``mesh.model`` positions)."""
        self.cfg = cfg
        self.tok = tokenizer
        self.mesh = mesh if mesh is not None else device_mesh(device, 1, cfg.mesh.model)
        self.device = self.mesh.devices[0]
        self.rank, self.world = data_parallel_world(cfg, self.mesh)
        self.np_rng = np.random.default_rng(cfg.ce_train.seed)
        self._init_state_dict = init_state_dict
        self.model: Optional[CrossEncoderModel] = None
        self.optimizer: Optional[Optimizer] = None
        self.ckpt = CheckpointManager(cfg.ce_train.checkpoint_dir, keep=cfg.ce_train.keep_checkpoints)
        self.log: List[Dict[str, Any]] = []
        self.steps: List[Dict[str, float]] = []

    def _init_state(self, total_steps: int) -> None:
        if self.model is not None:
            return
        c = self.cfg.ce_train
        model = CrossEncoderModel(self.cfg.ce_model)
        model.init_weights(torch.Generator().manual_seed(c.seed))
        if self._init_state_dict is not None:
            # a converted checkpoint or a grafted retriever BERT: what it
            # lacks (the head) keeps the fresh init
            model.load_state_dict(_merge_params(model.state_dict(), self._init_state_dict))
        self.model = place(model, self.mesh.grid[0])
        tc = TrainConfig(learning_rate=c.learning_rate, weight_decay=c.weight_decay,
                         max_grad_norm=c.max_grad_norm)
        self.optimizer = Optimizer(self.model, tc, self.cfg.ce_model, total_steps)

    # ---- pair building (host) ----

    def _build_pairs(
        self, examples: Sequence[Dict[str, Any]], mode: str
    ) -> Tuple[np.ndarray, np.ndarray, int, Optional[np.ndarray]]:
        c = self.cfg.ce_train
        pairs: List[Tuple[str, str]] = []
        teacher: List[List[float]] = []
        group = 0
        for ex in examples:
            q = ex["question"]
            if mode == "distill":
                # the retriever's top window with its scores, positive at
                # column 0: the KL target and the NLL anchor share one layout
                win = [(float(s), x) for s, x in ex["res_scored"][: c.distill_group]]
                if not win:
                    raise ValueError(
                        f"CE distill example has empty res_scored: "
                        f"question={ex['question']!r} (produce data with "
                        f"gen_distill_data / mine --distill-out)"
                    )
                while len(win) < c.distill_group:
                    # a huge-negative teacher score puts ~0 softmax mass on
                    # the duplicated slot
                    win.append((-1e4, win[-1][1]))
                pairs += [(q, x) for _, x in win]
                teacher.append([s for s, _ in win])
                group = c.distill_group
                continue
            if mode == "test":
                cands = ex["retrieval_res"][: c.eval_topk]
                pairs += [(q, p) for p in cands]
                group = c.eval_topk
                continue
            negs = list(ex["hard_negative_ctxs"])
            if not negs:
                raise ValueError(
                    f"CE {mode} example has no hard_negative_ctxs: "
                    f"question={ex['question']!r}"
                )
            neg_num = c.neg_num * 2 if mode == "dev" else c.neg_num
            while len(negs) < max(neg_num, c.neg_pool_hi if mode == "train" else neg_num):
                negs.append(negs[-1])
            if mode == "train":
                pos = ex["positive_ctxs"][self.np_rng.integers(len(ex["positive_ctxs"]))]
                pool = negs[c.neg_pool_lo : c.neg_pool_hi]
                idx = self.np_rng.choice(len(pool), size=neg_num, replace=False)
                chosen = [pool[i] for i in idx]
            else:
                pos = ex["positive_ctxs"][0]
                chosen = negs[:neg_num]
            pairs += [(q, pos)] + [(q, n) for n in chosen]
            group = 1 + neg_num
        enc = self.tok.encode_ce_pairs(pairs)
        t = np.asarray(teacher, np.float32) if teacher else None
        return enc.input_ids, enc.attention_mask, group, t

    # ---- steps ----

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _loss(self, ids, attn, group: int, teacher, generator) -> torch.Tensor:
        """This rank's mean loss over its questions of one (micro-)batch."""
        c = self.cfg.ce_train
        row0 = self.rank * ids.shape[0]  # this rank's first pair row in the global (micro-)batch
        scores = self.model(ids, attn, generator=DropoutRows(generator, row0)).reshape(-1, group) / c.score_temperature
        labels = torch.zeros(scores.shape[0], dtype=torch.long, device=scores.device)
        nll = biencoder_nll_loss(scores, labels)
        if c.distill_weight <= 0:
            return nll
        w = c.distill_weight
        return (1.0 - w) * nll + w * kl_loss(scores, teacher / c.distill_temperature)

    def _generator(self, *path: int) -> torch.Generator:
        return torch.Generator().manual_seed(fold_seed(self.cfg.ce_train.seed, *path))

    def compute_grads(self, ids: np.ndarray, attn: np.ndarray, group: int,
                      teacher: Optional[np.ndarray], gstep: int) -> torch.Tensor:
        """Forward and backward of step ``gstep`` over this rank's questions
        of the global batch (``ids``, ``attn``, ``teacher``): leaves the
        (micro-batch and rank averaged) gradients in ``.grad`` and returns
        the global batch's loss (a device scalar)."""
        self.model.train()
        self.optimizer.zero_grad()
        accum = max(1, self.cfg.ce_train.grad_accum_steps)
        n_q = ids.shape[0] // group
        if teacher is None:
            teacher = np.zeros((n_q, group), np.float32)
        # question-aligned micro-batches: each question's row stays whole
        ids, attn, teacher = (rank_rows(a, n_q, self.rank, self.world, accum) for a in (ids, attn, teacher))
        ids_t, attn_t, teacher_t = self._tensor(ids), self._tensor(attn), self._tensor(teacher)
        if accum == 1:
            loss = self._loss(ids_t, attn_t, group, teacher_t, self._generator(gstep))
            loss.backward()
        else:
            total = torch.zeros((), device=self.device)
            for i, (mi, ma, mt) in enumerate(zip(ids_t.chunk(accum), attn_t.chunk(accum), teacher_t.chunk(accum))):
                loss = self._loss(mi, ma, group, mt, self._generator(gstep, 100 + i))
                loss.backward()
                total += loss.detach()
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            torch._foreach_div_(grads, float(accum))
            loss = total / accum
        average_grads(self.optimizer.params)
        return mean_over_ranks(loss.detach())

    def train_step(self, ids, attn, group, teacher, gstep: int) -> torch.Tensor:
        loss = self.compute_grads(ids, attn, group, teacher, gstep)
        self.optimizer.step()
        return loss

    @torch.no_grad()
    def _score(self, ids: np.ndarray, attn: np.ndarray) -> np.ndarray:
        self.model.eval()
        return self.model(self._tensor(ids), self._tensor(attn)).cpu().numpy()

    # ---- public API ----

    def train(
        self,
        train_ds: RetrievalDataset,
        dev_ds: Optional[RetrievalDataset] = None,
        num_epochs: Optional[int] = None,
        resume: bool = False,
    ) -> List[float]:
        """Returns the losses of the steps this call ran."""
        c = self.cfg.ce_train
        epochs = num_epochs if num_epochs is not None else c.num_epochs
        bs = c.per_device_batch_size * self.world  # the global batch
        steps_per_epoch = max(1, len(train_ds) // bs)
        self._init_state(steps_per_epoch * epochs)

        start_step = 0
        if resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                self.model.load_state_dict(self.load_params_for_inference(latest))
                self.optimizer.load_state_dict(self.ckpt.load_train_state(latest)["optimizer"])
                start_step = latest
                logger.info("CE resumed from step %d", latest)

        eval_every = max(1, steps_per_epoch // max(1, c.evals_per_epoch))
        start_epoch = start_step // max(1, steps_per_epoch)
        gstep = start_epoch * steps_per_epoch
        losses: List[float] = []
        mode = "distill" if c.distill_weight > 0 else "train"
        for epoch in range(start_epoch, epochs):
            order = np.random.default_rng(c.seed + epoch).permutation(len(train_ds))
            for s in range(steps_per_epoch):
                idxs = order[s * bs : (s + 1) * bs]
                if len(idxs) < bs:
                    break
                if gstep < start_step:
                    gstep += 1  # deterministic fast-forward on resume
                    continue
                # a fresh generator a step: resume replays the same draws
                self.np_rng = np.random.default_rng((c.seed, gstep))
                ids, attn, group, teacher = self._build_pairs([train_ds[i] for i in idxs], mode)
                t0 = time.perf_counter()
                loss_f = float(self.train_step(ids, attn, group, teacher, gstep))  # waits for the step
                step_s = time.perf_counter() - t0
                gstep += 1
                if not np.isfinite(loss_f):
                    raise FloatingPointError(
                        f"non-finite CE loss {loss_f} at step {gstep} (epoch {epoch})"
                    )
                losses.append(loss_f)
                self.steps.append({"step": gstep, "loss": loss_f, "step_s": step_s})
                if gstep % c.log_every == 0 or gstep == 1:
                    logger.info("ce step %d loss=%.4f", gstep, float(np.mean(losses[-c.log_every:])))
                if gstep % eval_every == 0:
                    metrics = {"dev_mrr": self.evaluate(dev_ds)} if dev_ds is not None else {}
                    if metrics:
                        logger.info("ce step %d %s", gstep, metrics)
                    self.log.append({"step": gstep, "loss": loss_f, **metrics})
                    self.save(gstep, metrics)
        if gstep > start_step and self.ckpt.latest_step() != gstep:
            # a run that ends between evaluations still leaves its checkpoint
            # for the rerank stage
            self.save(gstep, {})
        self._dump_log()
        return losses

    def save(self, step: int, metrics: Optional[Dict[str, float]] = None) -> str:
        """Checkpoint ``step``: written by rank 0, between barriers."""
        barrier()
        if not self.rank:
            self.ckpt.save(
                step,
                reference_state_dict(self.model.state_dict(), self.cfg.ce_model, head_bias=True),
                {"optimizer": self.optimizer.state_dict(), "step": step},
                metadata={"metrics": metrics or {}, "config": self.cfg.to_dict()},
            )
        barrier()
        return str(self.ckpt.path(step))

    def load_params_for_inference(self, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The port state dict of CE checkpoint ``step`` (default: the latest)."""
        step = step if step is not None else self.ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no CE checkpoints under {self.ckpt.dir}")
        return state_dict_from_reference(self.ckpt.params_path(step), self.cfg.ce_model, head_bias=True)

    def load_for_inference(self, step: Optional[int] = None) -> None:
        """Build the model straight from CE checkpoint ``step`` (default: the
        latest) for :meth:`evaluate` and :meth:`rerank`: no seeded init and
        no optimizer."""
        params = self.load_params_for_inference(step)
        with torch.device("meta"):
            model = CrossEncoderModel(self.cfg.ce_model)
        model.load_state_dict(params, assign=True)
        self.model = place(model, self.mesh.grid[0])

    def _dump_log(self) -> None:
        if self.rank:
            return
        dump_jsonl(self.log, self.ckpt.dir / "ce_train_log.jsonl")
        dump_jsonl(self.steps, self.ckpt.dir / "ce_train_steps.jsonl")

    def evaluate(self, dev_ds: RetrievalDataset) -> float:
        """Dev MRR: the rank of the positive among its ``2 * neg_num`` negatives."""
        self._init_state(1)
        rrs = []
        bs = max(1, self.cfg.ce_train.per_device_batch_size)
        for s in range(0, len(dev_ds), bs):
            exs = [dev_ds[i] for i in range(s, min(len(dev_ds), s + bs))]
            ids, attn, group, _ = self._build_pairs(exs, "dev")
            scores = self._score(ids, attn).reshape(len(exs), group)
            ranks = (np.argsort(-scores, axis=1) == 0).argmax(axis=1)
            rrs += list(1.0 / (ranks + 1.0))
        return float(np.mean(rrs))

    def rerank(self, question: str, candidates: Sequence[str],
               params: Optional[Mapping[str, torch.Tensor]] = None, batch: int = 128) -> List[int]:
        """Candidate indices re-sorted by CE score (descending).  ``params``
        (a port state dict) is loaded into the model first; without it the
        live parameters score."""
        self._init_state(1)
        if params is not None:
            self.model.load_state_dict(params)
        scores = []
        for s in range(0, len(candidates), batch):
            chunk = candidates[s : s + batch]
            enc = self.tok.encode_ce_pairs([(question, p) for p in chunk])
            pad = batch - len(chunk)
            ids = np.pad(enc.input_ids, ((0, pad), (0, 0)))
            attn = np.pad(enc.attention_mask, ((0, pad), (0, 0)))
            scores.append(self._score(ids, attn)[: len(chunk)])
        scores = np.concatenate(scores)
        return list(np.argsort(-scores))

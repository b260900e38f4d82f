"""ColBERT retriever trainer, on one device or data-parallel: counterpart of
``colbert_tpu/training/trainer.py`` (``train`` :188-272, the train step
:122-159, ``evaluate`` :285-313).

* Train step: the query and doc passes in training mode (dropout on; every
  dropout site of the ``byte``/``hw`` impls runs kernel K9 forward and
  backward), all-pairs MaxSim by the differentiable torch einsum
  (``ops/maxsim.py::maxsim_ref``, as the JAX step scores with
  ``maxsim_xla``) over the temperature, labels ``arange * group``, NLL.
  ``grad_accum_steps`` splits the batch into group-aligned micro-batches
  whose in-batch negatives stay within each micro-batch, averaging their
  gradients, as the JAX step does.
* Dropout seeds: the query and doc passes of step ``s`` draw from
  generators seeded by ``(train.seed, s, 0)`` and ``(train.seed, s, 1)``
  (micro-batch ``i`` inserts ``100 + i``), the counterpart of
  ``fold_in(rng, s)``: resuming at a step reproduces the stream.
* Eval step: the passes in eval mode and MaxSim by kernel K3
  (``ops/maxsim.py::maxsim``), pad queries' doc columns at -inf.
* Bf16 compute, fp32 parameters and optimizer state (no loss scaling).
* Evaluation and a checkpoint every ``steps_per_epoch // evals_per_epoch``
  steps.
* Data parallelism (JAX ``:1-16``; a launch with one process a GPU,
  ``parallel/mesh.py::init_distributed``): every rank draws the same global
  batch of ``per_device_batch_size x world`` examples and takes its slice
  of each global micro-batch; the doc reps are all-gathered by a
  differentiable gather (``parallel/collectives.py``), so each query is
  scored against every doc of the global (micro-)batch; each rank's loss
  is the mean over its own queries and the gradients are averaged over
  ranks, once, which gives the one-device gradient of the global batch.
  Dropout counters start at the rank's first global row (K9,
  ``models/bert.py::DropoutRows``), so W ranks draw one device's masks.
  Eval gathers the reps and scores the global batch by K3 on every rank.
  Rank 0 alone writes checkpoints and logs, between barriers.
* Tensor parallelism (``mesh.model > 1``, JAX ``:64-97``): each rank's
  model is sharded over its model group (``models/sharding.py::place``),
  the passes run over its positions and the reps come back to its first
  device; the optimizer updates the shards and the replicated parameters,
  and checkpoints hold the gathered full parameters and moments, the same
  files at every ``mesh.model``.
"""

from __future__ import annotations

import hashlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from colbert_tpu_torch.config import ColbertConfig
from colbert_tpu_torch.models.bert import DropoutRows
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.convert import reference_state_dict, state_dict_from_reference
from colbert_tpu_torch.models.sharding import place
from colbert_tpu_torch.ops.maxsim import maxsim, maxsim_ref
from colbert_tpu_torch.parallel.collectives import (
    all_gather_rows, average_grads, barrier, gather_rows, mean_over_ranks, world,
)
from colbert_tpu_torch.parallel.mesh import Mesh, device_mesh
from colbert_tpu_torch.tokenization import ColbertTokenizer
from colbert_tpu_torch.training.checkpoint import CheckpointManager
from colbert_tpu_torch.training.dataset import RetrievalDataset, RetrievalSampler, TrainBatch
from colbert_tpu_torch.training.losses import biencoder_nll_loss, positive_ranks, reciprocal_ranks
from colbert_tpu_torch.training.train_state import Optimizer
from colbert_tpu_torch.utils.io import dump_jsonl
from colbert_tpu_torch.utils.logging import Timers, get_logger

logger = get_logger("trainer")


@dataclass
class TrainLog:
    steps: List[Dict[str, float]] = field(default_factory=list)
    evals: List[Dict[str, float]] = field(default_factory=list)


def fold_seed(*parts: int) -> int:
    """A 63-bit seed determined by ``parts`` (the counterpart of ``fold_in``)."""
    digest = hashlib.blake2b(repr(tuple(int(p) for p in parts)).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class ColbertTrainer:
    def __init__(
        self,
        cfg: ColbertConfig,
        tokenizer: ColbertTokenizer,
        device: str | torch.device = "cuda",
        init_state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        total_steps: Optional[int] = None,
        mesh: Optional[Mesh] = None,
    ):
        """``mesh``: this process's data position and its model group
        (default: ``device`` at ``mesh.model`` positions,
        ``parallel/mesh.py::device_mesh``)."""
        self.cfg = cfg
        self.tok = tokenizer
        self.mesh = mesh if mesh is not None else device_mesh(device, 1, cfg.mesh.model)
        self.device = self.mesh.devices[0]
        self.rank, self.world = data_parallel_world(cfg, self.mesh)
        self.model: Optional[ColbertModel] = None
        self.optimizer: Optional[Optimizer] = None
        self._init_state_dict = init_state_dict
        self._total_steps = total_steps
        self.ckpt = CheckpointManager(cfg.train.checkpoint_dir, keep=cfg.train.keep_checkpoints)
        self.timers = Timers()
        self.log = TrainLog()

    # ---- setup ----

    def _init_state(self, total_steps: int) -> None:
        if self.model is not None:
            return
        model = ColbertModel(self.cfg.model, self.cfg.multiview)
        model.init_weights(torch.Generator().manual_seed(self.cfg.train.seed))
        if self._init_state_dict is not None:
            # fill in what a converted checkpoint lacks (the projection head
            # of a bare pretrained BERT) from the fresh init
            model.load_state_dict(_merge_params(model.state_dict(), self._init_state_dict))
        self.model = place(model, self.mesh.grid[0])
        self.optimizer = Optimizer(self.model, self.cfg.train, self.cfg.model, total_steps)

    def _tensors(self, batch: TrainBatch):
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (batch.q_ids, batch.q_attn, batch.q_active, batch.d_ids, batch.d_attn, batch.d_active)
        )

    def _generators(self, *path: int):
        """Dropout generators of the query and doc passes at ``path`` (step[, micro-batch])."""
        return [torch.Generator().manual_seed(fold_seed(self.cfg.train.seed, *path, side))
                for side in (0, 1)]

    # ---- steps ----

    def _loss(self, tensors, generators) -> torch.Tensor:
        """This rank's mean NLL over its queries of one (micro-)batch, each
        query scored against every rank's docs."""
        q_ids, q_attn, q_active, d_ids, d_attn, d_active = tensors
        c = self.cfg.train
        group = c.train_num_positives + c.train_num_negatives
        q0 = self.rank * q_ids.shape[0]  # this rank's first query in the global (micro-)batch
        Q = self.model.query(q_ids, q_attn, generator=DropoutRows(generators[0], q0))
        D = self.model.doc(d_ids, d_attn, generator=DropoutRows(generators[1], q0 * group))
        scores = maxsim_ref(Q, gather_rows(D), q_active, all_gather_rows(d_active)) / c.score_temperature
        labels = (q0 + torch.arange(scores.shape[0], device=scores.device)) * group
        return biencoder_nll_loss(scores, labels)

    def compute_grads(self, batch: TrainBatch, gstep: int) -> torch.Tensor:
        """Forward and backward of step ``gstep`` over this rank's part of
        the global ``batch``: leaves the (micro-batch and rank averaged)
        gradients in ``.grad`` and returns the global batch's loss (a device
        scalar)."""
        self.model.train()
        self.optimizer.zero_grad()
        accum = max(1, self.cfg.train.grad_accum_steps)
        tensors = self._tensors(local_part(batch, self.rank, self.world, accum))
        if accum == 1:
            loss = self._loss(tensors, self._generators(gstep))
            loss.backward()
        else:
            # group-aligned micro-batches: in-batch negatives stay within each
            micro = [t.chunk(accum) for t in tensors]
            total = torch.zeros((), device=self.device)
            for i in range(accum):
                loss = self._loss([m[i] for m in micro], self._generators(gstep, 100 + i))
                loss.backward()
                total += loss.detach()
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            torch._foreach_div_(grads, float(accum))
            loss = total / accum
        average_grads(self.optimizer.params)
        return mean_over_ranks(loss.detach())

    def train_step(self, batch: TrainBatch, gstep: int) -> torch.Tensor:
        loss = self.compute_grads(batch, gstep)
        self.optimizer.step()
        return loss

    @torch.no_grad()
    def _eval_step(self, batch: TrainBatch, q_valid: np.ndarray):
        """Ranks of the global ``batch``'s queries: this rank encodes its
        part, every rank scores the gathered reps (K3)."""
        c = self.cfg.train
        group = c.eval_num_positives + c.eval_num_negatives
        q_ids, q_attn, q_active, d_ids, d_attn, d_active = self._tensors(
            local_part(batch, self.rank, self.world, 1))
        Q = all_gather_rows(self.model.query(q_ids, q_attn))
        D = all_gather_rows(self.model.doc(d_ids, d_attn))
        scores = maxsim(Q, D, all_gather_rows(q_active), all_gather_rows(d_active))
        # pad rows (dev set smaller than the fixed batch): their doc columns
        # must not perturb real queries' rankings
        doc_valid = torch.from_numpy(q_valid).to(self.device).repeat_interleave(group)
        scores = torch.where(doc_valid[None, :], scores, torch.full_like(scores, float("-inf")))
        num_pos = c.eval_num_positives
        return positive_ranks(scores, group, num_pos), reciprocal_ranks(scores, group, num_pos)

    # ---- public API ----

    def train(
        self,
        train_ds: RetrievalDataset,
        dev_ds: Optional[RetrievalDataset] = None,
        num_epochs: Optional[int] = None,
        resume: bool = False,
    ) -> TrainLog:
        c = self.cfg.train
        epochs = num_epochs if num_epochs is not None else c.num_epochs
        batch_size = c.per_device_batch_size * self.world  # the global batch
        sampler = RetrievalSampler(train_ds, self.tok, c, batch_size, is_eval=False)
        steps_per_epoch = sampler.steps_per_epoch()
        total_steps = self._total_steps or max(1, steps_per_epoch * epochs)
        self._init_state(total_steps)

        start_step = 0
        if resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                self._load_params(latest)
                self.optimizer.load_state_dict(self.ckpt.load_train_state(latest)["optimizer"])
                start_step = latest
                logger.info("resumed from step %d", latest)

        eval_every = max(1, steps_per_epoch // max(1, c.evals_per_epoch))
        start_epoch = start_step // max(1, steps_per_epoch)
        gstep = start_epoch * steps_per_epoch
        running_loss, running_n = 0.0, 0
        t_start = time.perf_counter()
        for epoch in range(start_epoch, epochs):
            for batch in sampler.epoch(epoch):
                if gstep < start_step:
                    gstep += 1  # deterministic dataloader fast-forward on resume
                    continue
                t0 = time.perf_counter()
                with self.timers.span("train_step"):
                    loss_f = float(self.train_step(batch, gstep))  # waits for the step
                step_s = time.perf_counter() - t0
                gstep += 1
                if not np.isfinite(loss_f):
                    raise FloatingPointError(f"non-finite loss {loss_f} at step {gstep} (epoch {epoch})")
                running_loss += loss_f
                running_n += 1
                if gstep % c.log_every == 0 or gstep == 1:
                    elapsed = time.perf_counter() - t_start
                    avg = running_loss / max(1, running_n)
                    rate = running_n * batch_size / elapsed
                    logger.info("step %d/%d loss=%.4f ex/s=%.1f", gstep, total_steps, avg, rate)
                    self.log.steps.append({"step": gstep, "loss": avg, "examples_per_s": rate,
                                           "step_loss": loss_f, "step_s": step_s})
                if gstep % eval_every == 0:
                    metrics = self.evaluate(dev_ds) if dev_ds is not None else {}
                    self.save(gstep, metrics)
        self._dump_log()
        return self.log

    def _dump_log(self) -> None:
        """Step and eval metrics as JSONL next to the checkpoints, and the span timers (rank 0)."""
        if self.rank:
            return
        rows = [{"kind": "step", **s} for s in self.log.steps] + [
            {"kind": "eval", **e} for e in self.log.evals
        ]
        dump_jsonl(rows, self.ckpt.dir / "train_log.jsonl")
        self.timers.dump(str(self.ckpt.dir / "timers.json"))

    def evaluate(self, dev_ds: RetrievalDataset) -> Dict[str, float]:
        c = self.cfg.train
        # a fixed global batch; the partial final batch is padded and its pad rows masked
        batch_size = c.per_device_batch_size * self.world
        sampler = RetrievalSampler(dev_ds, self.tok, c, batch_size, is_eval=True, drop_last=False)
        group = c.eval_num_positives + c.eval_num_negatives
        self.model.eval()
        ranks, rrs = [], []
        for batch in sampler.epoch(0):
            n_real = batch.q_ids.shape[0]
            batch = _pad_batch(batch, batch_size, group)
            q_valid = np.zeros(batch_size, bool)
            q_valid[:n_real] = True
            r, rr = self._eval_step(batch, q_valid)
            ranks += r[:n_real].tolist()
            rrs += rr[:n_real].tolist()
        metrics = {
            "eval_mean_positive_rank": float(np.mean(ranks)) if ranks else float("nan"),
            "eval_mrr": float(np.mean(rrs)) if rrs else float("nan"),
        }
        logger.info("eval: %s", metrics)
        self.log.evals.append(metrics)
        return metrics

    def evaluate_checkpoints(self, dev_ds: RetrievalDataset) -> Dict[int, Dict[str, float]]:
        """Evaluate every saved checkpoint (the reference's checkpoint-dir
        evaluation loop); the live parameters are restored afterwards."""
        steps = self.ckpt.all_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.ckpt.dir}")
        self._init_state(total_steps=max(steps))
        original = {k: v.clone() for k, v in self.model.state_dict().items()}
        out: Dict[int, Dict[str, float]] = {}
        for step in steps:
            self._load_params(step)
            out[step] = self.evaluate(dev_ds)
            logger.info("checkpoint-%d: %s", step, out[step])
        self.model.load_state_dict(original)
        return out

    def save(self, step: int, metrics: Optional[Dict[str, float]] = None) -> str:
        """Checkpoint ``step``: written by rank 0, between barriers."""
        barrier()
        if not self.rank:
            self.ckpt.save(
                step,
                reference_state_dict(self.model.state_dict(), self.cfg.model),
                {"optimizer": self.optimizer.state_dict(), "step": step},
                metadata={"metrics": metrics or {}, "config": self.cfg.to_dict()},
            )
        barrier()
        return str(self.ckpt.path(step))

    def _load_params(self, step: int) -> None:
        self.model.load_state_dict(state_dict_from_reference(self.ckpt.params_path(step), self.cfg.model))

    def load_params_for_inference(self, step: Optional[int] = None) -> Dict[str, torch.Tensor]:
        """The port state dict of checkpoint ``step`` (default: the latest)."""
        step = step if step is not None else self.ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.ckpt.dir}")
        return state_dict_from_reference(self.ckpt.params_path(step), self.cfg.model)


def data_parallel_world(cfg: ColbertConfig, mesh: Mesh) -> Tuple[int, int]:
    """``(rank, world size)`` of a training run: the launch's process group
    (one process a data position), checked against the config's ``mesh``
    (``data`` -1 or the world size) and the process's own ``mesh`` (one
    data position of ``mesh.model`` positions)."""
    rank, size = world()
    if mesh.data != 1 or mesh.model != cfg.mesh.model:
        raise ValueError(f"a trainer runs one data position of mesh.model={cfg.mesh.model} positions, "
                         f"got a {mesh.data}x{mesh.model} mesh")
    if cfg.mesh.data not in (-1, size):
        raise ValueError(
            f"mesh.data={cfg.mesh.data}, but training runs one process a device and this run has {size}: "
            "launch one process a GPU (or a model group of GPUs) with --coordinator/--num-processes/--process-id, "
            "or set mesh.data=-1"
        )
    return rank, size


def rank_rows(a: np.ndarray, n_q: int, rank: int, size: int, accum: int) -> np.ndarray:
    """Rank ``rank``'s rows of ``a``, whose rows belong to ``n_q`` questions
    in order (one row each, or a group each): its slice of each of the
    ``accum`` global micro-batches, concatenated."""
    if n_q % (accum * size):
        raise ValueError(f"a batch of {n_q} does not split into grad_accum_steps={accum} equal micro-batches "
                         f"over {size} ranks")
    if size == 1 and accum == 1:
        return a
    return a.reshape(accum, size, -1, *a.shape[1:])[:, rank].reshape(-1, *a.shape[1:])


def local_part(batch: TrainBatch, rank: int, size: int, accum: int) -> TrainBatch:
    """:func:`rank_rows` of every array of a global batch."""
    n_q = batch.q_ids.shape[0]
    return TrainBatch(*(rank_rows(a, n_q, rank, size, accum) for a in (
        batch.q_ids, batch.q_attn, batch.q_active, batch.d_ids, batch.d_attn, batch.d_active)))


def _pad_batch(batch: TrainBatch, batch_size: int, group: int) -> TrainBatch:
    """Pad a partial eval batch up to ``batch_size`` queries (and
    ``batch_size * group`` docs) with zero rows; callers mask the pad rows."""
    n = batch.q_ids.shape[0]
    if n == batch_size:
        return batch
    padq = lambda a: np.pad(a, ((0, batch_size - n), (0, 0)))
    padd = lambda a: np.pad(a, ((0, (batch_size - n) * group), (0, 0)))
    return TrainBatch(
        padq(batch.q_ids), padq(batch.q_attn), padq(batch.q_active),
        padd(batch.d_ids), padd(batch.d_attn), padd(batch.d_active),
    )


def _merge_params(full: Mapping[str, torch.Tensor], partial: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Overlay ``partial`` (possibly missing the head) onto the fresh ``full``
    -- the analogue of the reference's ``strict=False`` load."""
    return {k: partial[k] if k in partial else v for k, v in full.items()}

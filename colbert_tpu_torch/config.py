"""Typed configuration system: the port's copy of ``colbert_tpu/config.py``.

The same dataclasses, defaults, validation and YAML round trip, so one
config file drives both packages (``tests/test_torch_config.py`` holds the
two equal).  A copy, not an import: the port imports nothing of
``colbert_tpu``.  The comments on the fields describe the JAX package's
options; the port computes the same results and refuses the options it has
not ported (``ranking/searcher.py``, ``cli.py``).

Replaces the reference's two-headed OmegaConf YAML + HF ``TrainingArguments``
spine (reference: ``proj_conf/dense.yaml``, ``colbert/utils/dense_conf.py:26-29``,
``proj_conf/training_arguments.py``) with plain dataclasses that load from a
single YAML file and validate eagerly.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import yaml


def _from_dict(cls, data: Dict[str, Any]):
    """Recursively build a dataclass from a nested dict, validating keys."""
    if data is None:
        return cls()
    field_map = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(field_map)
    if unknown:
        raise ValueError(f"unknown config keys for {cls.__name__}: {sorted(unknown)}")
    kwargs = {}
    for name, value in data.items():
        ftype = field_map[name].type
        target = _DATACLASS_FIELDS.get((cls, name))
        if target is not None and isinstance(value, dict):
            kwargs[name] = _from_dict(target, value)
        elif ftype in ("float", float) and isinstance(value, str):
            # YAML 1.1 parses dot-less exponents ("1e-3") as STRINGS; a raw
            # string would surface as a cryptic optax TypeError mid-train
            kwargs[name] = float(value)
        elif ftype in ("int", int) and isinstance(value, str):
            kwargs[name] = int(value)
        else:
            kwargs[name] = value
    return cls(**kwargs)


@dataclass
class ModelConfig:
    """BERT encoder hyper-parameters (reference: ``chinese-bert-wwm-ext`` /
    ``macbert_large``, resolved via ``dense_conf.py:6-12``)."""

    vocab_size: int = 21128           # bert-base-chinese vocab
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    # ColBERT projection head (reference: bias-free Linear(hidden, dim),
    # colbert_model.py:49)
    dim: int = 768
    # compute dtype for the encoder under jit; params stay fp32
    dtype: str = "bfloat16"
    # attention backend: "xla" (einsum + fp32 softmax), "flash" (fused Pallas
    # flash-attention kernel: no (B,h,L,L) HBM intermediate, fwd+bwd), or
    # "auto" (currently = xla: measured on v5e at the reference operating
    # point, the generic flash kernel is SLOWER for BERT-base at seq 384 —
    # 375.5 vs 288.5 ms/step; its bwd pass dominates.  flash remains
    # selectable for long-sequence models where it wins).
    # The flash kernel has no attention-probs dropout; when
    # attention_dropout > 0 an equivalent-strength dropout is applied to the
    # attention OUTPUT instead (documented deviation; same parameter tree).
    attention_impl: str = "auto"
    # dropout PRNG width: "byte" draws an 8-bit field per element — 4 mask
    # bytes per threefry word, with the drop probability quantized to 1/256
    # (0.1 -> 26/256).  Measured: dropout bit-generation was 108 ms of the
    # 288 ms train step (xla+nodrop bisect), almost all of it the
    # (B, h, L, L) attention-probs masks.  "exact" is flax nn.Dropout (one
    # 32-bit draw per element).  "hw" generates mask bytes with the TPU
    # per-core hardware PRNG in a zero-residual Pallas kernel
    # (ops/dropout_pallas.py) — the mask is regenerated in bwd, never
    # stored.
    dropout_impl: str = "byte"
    # where attention dropout acts: "probs" (reference semantics: drop
    # attention probabilities, hf BertSelfAttention) or "output" (drop the
    # attended context instead — L x fewer random bits at equal rate; the
    # flash path always does this).
    attention_dropout_site: str = "probs"
    # activation rematerialization for the encoder layers: "none", "dots"
    # (save only matmul outputs), "full" (save nothing; recompute all), or
    # "attn" (save everything except the (B, h, L, L) attention
    # logits/probs — recomputed in bwd from the saved q/k at ~2% extra
    # FLOPs; drops the layer's largest residual entirely).
    # "dots"/"full" trade extra fwd FLOPs for O(L) activation memory —
    # enable much larger per-chip batches.
    remat: str = "none"
    # fuse the q/k/v projections into ONE (H, 3H) matmul per layer (kernels
    # concatenated at apply time; the parameter tree keeps the separate HF
    # query/key/value entries, so checkpoint conversion is unchanged).
    fused_qkv: bool = False
    # attention logits/softmax dtype: "fp32" (reference semantics; the
    # (B, h, L, L) logits materialize in fp32) or "compute" (logits and
    # softmax in the compute dtype — halves the attention HBM traffic at
    # bf16; softmax is max-subtracted so bf16 is stable for BERT-scale
    # logits, but this is a documented numerics deviation).
    attention_softmax_dtype: str = "fp32"
    # word-embedding lookup: "take" (gather fwd / scatter-add bwd) or
    # "onehot" (one-hot matmul both ways — the embedding gradient becomes a
    # dense MXU matmul instead of a serialized scatter-add; pays
    # O(tokens x vocab x hidden) extra FLOPs, a win when the scatter is the
    # bottleneck and vocab is small).
    embedding_impl: str = "take"


@dataclass
class MultiviewConfig:
    """Multi-view document representations (ACL'22 MVR variant).

    Reference: ``dense.yaml:29-32`` (enabled, q_view=16, d_view=16);
    semantics in ``BaseModel.py:21-27`` (slice first ``view_num`` positions)
    and ``tokenizers.py:42-63`` (distinct ``[unusedN]`` marker tokens, only
    view positions are scored).
    """

    enabled: bool = True
    q_view: int = 16
    d_view: int = 16


@dataclass
class TokenizerConfig:
    """Reference: ``tokenizers.py``; lengths from ``dense.yaml:6-7``."""

    vocab_path: str = ""              # path to a BERT vocab.txt (required at runtime)
    query_maxlen: int = 32
    doc_maxlen: int = 384
    ce_maxlen: int = 384
    do_lower_case: bool = True


@dataclass
class TrainConfig:
    """Retriever training operating point (reference: ``eval.sh:12-19``,
    ``dense.yaml:4``: lr 3e-5, per-device batch 34, 20 epochs, T=0.05)."""

    learning_rate: float = 3e-5
    weight_decay: float = 0.01
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    warmup_ratio: float = 0.0
    max_grad_norm: float = 1.0
    per_device_batch_size: int = 34
    # micro-batching: each optimizer step averages grads over this many
    # sequential micro-batches (lax.scan inside the jitted step)
    grad_accum_steps: int = 1
    num_epochs: int = 20
    score_temperature: float = 0.05
    seed: int = 1234
    # sampling (reference: colbert_model.py:56-77)
    train_num_positives: int = 1
    train_num_negatives: int = 1
    train_negative_pool: int = 50
    # PRNG implementation for dropout keys: "threefry" (JAX default) or
    # "rbg" (XLA RngBitGenerator).  Measured on v5e at the reference
    # operating point: rbg is 2.1x SLOWER end-to-end (613 vs 288 ms/step) —
    # keep threefry unless a future runtime changes that.
    rng_impl: str = "threefry"
    # doc-length bucketing: per batch, truncate the doc arrays to the
    # smallest listed length >= the batch's longest doc (static-shape
    # analogue of the reference's truncate-to-batch-max, encoder.py:171-172;
    # one XLA compile per bucket).  Multiples of 128 keep the flash-attention
    # auto path active.  Empty = always pad to tokenizer.doc_maxlen.
    doc_length_buckets: Tuple[int, ...] = ()
    # length-grouped shuffling: after the epoch shuffle, sort examples by a
    # doc-length proxy within pools of N batches, so each batch's longest
    # doc (the bucketing truncation point) tracks the LOCAL length scale
    # instead of the corpus p99.  0 = off.  Without this, heavy-tailed
    # doclen distributions defeat doc_length_buckets (a random batch of 68
    # docs almost always contains a near-maxlen one).
    length_group_pool: int = 0
    eval_num_positives: int = 2
    eval_num_negatives: int = 8
    # evaluation / checkpoint cadence: twice per epoch
    # (reference: mytrainer_callbacks.py:31-35)
    evals_per_epoch: int = 2
    checkpoint_dir: str = "checkpoints/colbert"
    keep_checkpoints: int = 20
    log_every: int = 50


@dataclass
class CETrainConfig:
    """Cross-encoder reranker (reference: ``dense.yaml:40-52``, ``eval.sh:43-50``)."""

    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    per_device_batch_size: int = 4
    grad_accum_steps: int = 1
    num_epochs: int = 5
    score_temperature: float = 1.0
    neg_num: int = 4
    neg_pool_lo: int = 5              # train negs sampled from hard_negatives[5:50]
    neg_pool_hi: int = 50
    eval_topk: int = 100              # rerank top-100 (ce_test_args.eval_topk)
    max_grad_norm: float = 1.0
    seed: int = 1234
    rng_impl: str = "threefry"        # see TrainConfig.rng_impl
    # eval + checkpoint cadence: same half-epoch machinery as the retriever
    # (reference runs CE through the same callbacks, mytrainer_callbacks.py:31-35)
    evals_per_epoch: int = 2
    keep_checkpoints: int = 20
    log_every: int = 50
    checkpoint_dir: str = "checkpoints/ce"
    # warm-start the CE's BERT encoder from the trained retriever's latest
    # checkpoint (train.checkpoint_dir).  The reference's CE rides a
    # PRETRAINED backbone (macbert, dense.yaml:40); a from-scratch CE is
    # data-starved on retrieval-sized training sets (measured: near-random
    # top-100 rerank after 5 epochs on pydocs).  Transfer from the
    # bi-encoder's backbone is the no-pretraining analogue — requires
    # ce_model and model to share the BERT shape.
    init_from_retriever: bool = False
    # distill the bi-encoder into the CE (ColBERTv2-style): training
    # examples carry ``res_scored`` = [[teacher_score, text], ...] (the
    # retriever's own top-k scores, gen_distill_data) with the positive at
    # column 0; loss = (1-w)*NLL + w*KL(teacher || student).  0 = off.
    distill_weight: float = 0.0
    # temperature applied to the TEACHER scores before softmax (MaxSim
    # scores are ~[0, q_view]-scaled; 1.0 keeps them sharp)
    distill_temperature: float = 1.0
    # window size (1 + negatives) taken from res_scored per question
    distill_group: int = 8


@dataclass
class IndexConfig:
    """IVF-PQ index build (reference: ``dense.yaml:25-28``,
    ``faiss_indexers.py:279-286``)."""

    index_path: str = "index/colbert"
    # candidate codec:
    #   "pq"  — reference-parity IVF-PQ (m=64 x 8-bit, 64 B/vector); ADC is
    #           a table gather, slow on TPU — kept for strict parity;
    #   "pq4" — fast-scan PQ (m=128 x 4-bit, 64 B/vector, faiss's
    #           IndexIVFPQFastScan analogue): ADC as an MXU one-hot matmul
    #           (ops/pq4.py) — the fast PQ family member on TPU;
    #   "sq"  — TPU-first int8 projected codec (sq_dim B/vector): candidate
    #           scoring is a plain int8 MXU matmul; best large-corpus scaling.
    codec: str = "pq"
    # PQ: m sub-quantizers x 2^nbits codes (64 B / token-vector at defaults)
    pq_m: int = 64
    pq_nbits: int = 8
    # PQ4 fast-scan: m 4-bit sub-quantizers (m/2 B per vector)
    pq4_m: int = 128
    # SQ: PCA projection width (bytes per vector)
    sq_dim: int = 64
    # IVF partitions; 0 = auto: 1 << round(log2(8 * sqrt(num_embeddings)))
    partitions: int = 0
    # corpus encode
    encode_batch_size: int = 384
    num_parts: int = 12               # on-disk shards (reference: encoder.py:41)
    # balanced assignment: cap each IVF list at
    # ceil(mean_list_len * balance_factor) rows (points spill to their next-
    # nearest centroid with free capacity).  0 = plain nearest-centroid
    # assignment (faiss parity).  Shrinks max_list_len (p99 skew) toward the
    # mean, which bounds probe-window padding and slot-count skew.
    balance_factor: float = 0.0
    balance_candidates: int = 8
    # k-means
    kmeans_iters: int = 20
    pq_kmeans_iters: int = 25
    train_sample_parts: int = 3       # PQ/IVF trained on parts 0..2 (faiss_indexers.py:204-212)
    max_train_points: int = 1 << 20
    embedding_dtype: str = "float16"  # stored dtype (reference: encoder.py:175)


@dataclass
class ServeConfig:
    """Serving operating point (reference: ``dense_server_client.py:81,111``)."""

    # retrieval mode: "ann" (IVF probe -> candidate funnel -> exact rerank)
    # or "flat" (exact brute-force MaxSim over the whole doc-major table on
    # the MXU, ops/flat_scan.py — recall 1.0 by construction; measured
    # FASTER than the ANN funnel wherever the table is HBM-resident, because
    # the funnel's residual cost is gather overhead ~86 ns/row while the MXU
    # scores the entire corpus in one streaming pass).  "flat" needs no IVF
    # index at all: it serves straight from the encoded parts.
    mode: str = "ann"
    # flat mode: docs per top-k segment (bounds the transposed transient)
    flat_segment_docs: int = 1 << 17
    # flat mode: rows per kernel grid step (0 = auto ~1024); must divide the
    # padded table and hold whole docs.  Exposed for block-size sweeps.
    flat_rows_block: int = 0
    # flat mode: fused two-stage top-k — the scan kernel also emits per-grid-
    # step group maxima, and selection reads only the winning groups' scores
    # (exact: a top-k doc's group max bounds its score, so top-k groups cover
    # the top-k docs).  Replaces the full-matrix flat_topk merge loops
    # (~0.6 GB of working set + the dominant selection cost at 1M docs).
    flat_fused_topk: bool = True
    # flat mode, fused path: stored score dtype.  "auto" = float32 below
    # 256k docs (tie-exact headline), bfloat16 above (halves the score
    # matrix — the memory that capped the 1M-doc per-chip envelope).
    flat_score_dtype: str = "auto"
    nprobe: int = 128
    candidate_depth: int = 512        # a.k.a. faiss_depth
    topk: int = 100
    query_batch_size: int = 144
    # fixed candidate budget after pid dedup (static shape for XLA)
    max_candidates: int = 4096
    # candidate ranking for the dedup stage: "approx_maxsim" (WARP/PLAID-
    # style per-token max + sum) or "best_row" (best single codec score per
    # doc).  Measured on v5e at 20k docs: approx_maxsim costs nothing end-to-
    # end and degrades far more gracefully as max_candidates shrinks
    # (recall@100 at max_candidates=1024: 0.948 vs best_row's 0.854).
    candidate_ranking: str = "approx_maxsim"
    # TPU-optimized approximate top-k in the probe stage (~2x; recall-safe:
    # candidates feed an exact MaxSim re-rank)
    approx_probe_topk: bool = True
    # probe implementation for the sq codec: "batched" scans each probed IVF
    # list once per query batch (list-major, see ops/sq_probe_batched.py);
    # "token" scans per (token, list) pair (round-1 kernel).  "auto" =
    # batched.  PQ always uses the token-major ADC path.
    probe_impl: str = "auto"
    # batched probe: rows kept per (token, probed list) before the per-token
    # top-depth.  Candidates per token = nprobe * probe_list_topr.
    probe_list_topr: int = 8
    # batched probe: the N most-probed lists are scanned densely against all
    # tokens (probe popularity is heavily skewed; a list over the slot
    # capacity would otherwise truncate pairs).  Must exceed the number of
    # lists whose member count tops the groups*tpl=1024 slot capacity (46 at
    # the 20k-doc bench point) — raising nprobe lowers every token's
    # membership threshold and multiplies overflowing lists (measured at
    # 200k docs/K=16384: nprobe 128->256 at hot=64 DROPPED recall@100
    # 0.779 -> 0.652 from silently truncated pairs).  0 = auto:
    # max(64, nprobe), which keeps nprobe<=64 configs bit-identical and
    # scales the dense scan with probe width (the scan is one fat matmul
    # per 128-row block — adding hot lists is far cheaper than lost pairs).
    probe_hot_lists: int = 0
    # candidate dedup implementation: "packed" sorts ONE int32 per entry
    # (pid+token key in the high bits, per-query-quantized score in the low
    # bits) and selects the budget with approx_max_k — recall-safe (the
    # output feeds an exact re-rank; only membership matters) and ~2x the
    # two-operand sort + exact top_k.  "exact" keeps fp32 scores end-to-end.
    # "auto" = packed on TPU when the key fits 31 bits, exact elsewhere.
    dedup_impl: str = "auto"
    # exact re-rank backend: "pallas" (fused DMA-streamed gather+MaxSim
    # kernel; measured 253 -> 306 QPS on v5e at identical recall) or "xla"
    # (gather + einsum).  pallas applies to uniform-doclen corpora with
    # max_candidates % 128 == 0 and silently falls back to xla otherwise.
    rerank_kernel: str = "pallas"
    # re-rank embedding table dtype: "bfloat16" (default), "float32", or
    # "int8" (lane-packed per-dim-quantized table: 4x corpus per HBM byte —
    # the beyond-HBM serving mode; requires a multiview/uniform corpus).
    # The reference's analogue is the fp16 CPU-resident flat table
    # (colbert_ranker.py:61-73) bounded by host RAM; here the bound is
    # HBM / (d_view * dim) bytes per doc.
    rerank_dtype: str = "bfloat16"
    # where the exact-rerank table lives: "hbm" (device-resident — fastest)
    # or "host" (int8 table in HOST RAM, the reference's own placement:
    # corpus bounded by hundreds of GB instead of HBM).  With "host", the
    # device pipeline stops at the ranked candidate set and only the top
    # host_rerank_candidates docs per query are gathered from the host
    # table and shipped to the device for exact MaxSim — a PLAID-style
    # funnel that keeps the PCIe/host traffic ~topk-sized.  Requires a
    # uniform-doclen (multiview) corpus.
    rerank_table: str = "hbm"
    host_rerank_candidates: int = 256
    # batches kept in flight by RetrievalService.retrieve (async dispatch
    # via search_tokens_device): batch i+1 tokenizes + dispatches while the
    # device runs batch i.  1 = synchronous (the reference's serving shape).
    pipeline_inflight: int = 3
    host: str = "127.0.0.1"
    port: int = 9090
    authkey: str = "colbert-tpu"


@dataclass
class MeshConfig:
    """Device mesh layout (``parallel/mesh.py::make_mesh``).  ``data``: the
    positions the batch or the corpus is split over, -1 for every device.
    In the port, ``encode`` splits each batch over ``data`` GPUs of one
    process and ``ranking/sharded.py`` keeps a corpus shard on each; a
    launch (one process a GPU, the CLI's ``--coordinator``) trains
    data-parallel over its ranks, where ``data`` must be -1 or their
    number.  ``model`` shards attention heads and the MLP (tensor
    parallelism, as the JAX package does): in the port each data position
    holds ``model`` positions of one process (``models/sharding.py``), and
    a launch's rank takes ``model`` GPUs.  The reference only has NCCL DDP
    (``distributed.py``); TP/PP do not exist there."""

    data: int = -1                    # -1 = all devices
    model: int = 1


@dataclass
class ColbertConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    ce_model: ModelConfig = field(default_factory=lambda: ModelConfig(hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096))
    multiview: MultiviewConfig = field(default_factory=MultiviewConfig)
    tokenizer: TokenizerConfig = field(default_factory=TokenizerConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    ce_train: CETrainConfig = field(default_factory=CETrainConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    workspace: str = "workspace"

    def __post_init__(self):
        if self.multiview.enabled:
            if self.multiview.q_view > self.tokenizer.query_maxlen:
                raise ValueError("q_view must fit in query_maxlen")
            if self.multiview.d_view > self.tokenizer.doc_maxlen:
                raise ValueError("d_view must fit in doc_maxlen")
        if self.index.codec not in ("pq", "pq4", "sq"):
            raise ValueError(f"unknown index codec: {self.index.codec}")
        if self.index.codec == "pq" and self.model.dim % self.index.pq_m != 0:
            raise ValueError(
                f"PQ requires dim % m == 0, got dim={self.model.dim} m={self.index.pq_m}"
            )
        if self.index.codec == "pq4":
            if self.model.dim % self.index.pq4_m != 0 or self.index.pq4_m % 2 != 0:
                raise ValueError(
                    f"PQ4 requires even m dividing dim, got dim={self.model.dim} "
                    f"m={self.index.pq4_m}"
                )
        if self.index.codec == "sq" and self.index.sq_dim > self.model.dim:
            raise ValueError("sq_dim must be <= model dim")
        if self.model.remat not in ("none", "dots", "full", "attn"):
            raise ValueError(f"unknown remat policy: {self.model.remat}")
        if self.model.dropout_impl not in ("byte", "exact", "hw"):
            raise ValueError(f"unknown dropout_impl: {self.model.dropout_impl}")
        if self.model.attention_dropout_site not in ("probs", "output"):
            raise ValueError(
                f"unknown attention_dropout_site: {self.model.attention_dropout_site}"
            )
        if self.model.attention_softmax_dtype not in ("fp32", "compute"):
            raise ValueError(
                f"unknown attention_softmax_dtype: {self.model.attention_softmax_dtype}"
            )
        if self.model.embedding_impl not in ("take", "onehot"):
            raise ValueError(f"unknown embedding_impl: {self.model.embedding_impl}")
        if self.serve.rerank_table not in ("hbm", "host"):
            raise ValueError(
                f"serve.rerank_table must be 'hbm' or 'host', got {self.serve.rerank_table!r}"
            )
        if self.serve.mode not in ("ann", "flat"):
            raise ValueError(
                f"serve.mode must be 'ann' or 'flat', got {self.serve.mode!r}"
            )
        if self.serve.flat_score_dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                f"serve.flat_score_dtype must be 'auto', 'float32' or "
                f"'bfloat16', got {self.serve.flat_score_dtype!r}"
            )

    # ---- (de)serialization ----

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ColbertConfig":
        return _from_dict(cls, dict(data))

    @classmethod
    def from_yaml(cls, path: str | Path) -> "ColbertConfig":
        with open(path, "r", encoding="utf8") as f:
            return cls.from_dict(yaml.safe_load(f) or {})

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_yaml(self, path: str | Path) -> None:
        with open(path, "w", encoding="utf8") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False, allow_unicode=True)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), ensure_ascii=False)

    # ---- derived quantities ----

    @property
    def doc_vectors_static(self) -> Optional[int]:
        """Number of vectors per doc when it is statically known (multiview)."""
        return self.multiview.d_view if self.multiview.enabled else None


# nested-dataclass routing table for _from_dict
_DATACLASS_FIELDS: Dict[Tuple[type, str], type] = {
    (ColbertConfig, "model"): ModelConfig,
    (ColbertConfig, "ce_model"): ModelConfig,
    (ColbertConfig, "multiview"): MultiviewConfig,
    (ColbertConfig, "tokenizer"): TokenizerConfig,
    (ColbertConfig, "train"): TrainConfig,
    (ColbertConfig, "ce_train"): CETrainConfig,
    (ColbertConfig, "index"): IndexConfig,
    (ColbertConfig, "serve"): ServeConfig,
    (ColbertConfig, "mesh"): MeshConfig,
}


def load_config(path: Optional[str | Path] = None, overrides: Optional[Dict[str, Any]] = None) -> ColbertConfig:
    """Load a config from YAML with optional dotted-key overrides.

    ``overrides`` maps dotted paths (``"train.learning_rate"``) to values —
    the CLI analogue of the reference's HfArgumentParser flags.
    """
    cfg = ColbertConfig.from_yaml(path) if path else ColbertConfig()
    if overrides:
        data = cfg.to_dict()
        for key, value in overrides.items():
            node = data
            parts = key.split(".")
            for p in parts[:-1]:
                if not isinstance(node, dict) or p not in node:
                    raise ValueError(f"unknown override key: {key}")
                node = node[p]
            if not isinstance(node, dict) or parts[-1] not in node:
                raise ValueError(f"unknown override key: {key}")
            node[parts[-1]] = value
        cfg = ColbertConfig.from_dict(data)
    return cfg

"""colbert-tpu-torch: the PyTorch/CUDA port of ``colbert_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, mirroring its module names so each
counterpart is easy to find.  The JAX package stays the reference: every
module here is tested against it on the CPU (``tests/test_torch_*.py``).

Slices ported so far:

* exact flat serving: tokenizer -> BERT + ColBERT head -> hand-written CUDA
  MaxSim scan (``csrc/flat_scan.cu``) -> two-stage top-k -> the reference's
  socket protocol, plus the corpus encoder that writes the part files;
* single-device retriever training (``training/``): dropout by the
  hand-written Philox kernel (``csrc/dropout.cu``, forward and backward),
  the eval step's all-pairs MaxSim kernel (``csrc/maxsim.cu``), AdamW,
  checkpoints in the reference ``pytorch.bin`` layout;
* the IVF index with the sq codec (``indexing/builder.py``) and ANN
  serving: the list-major probe (``csrc/sq_probe.cu``), pid dedup and the
  fused gather + MaxSim rerank over a bf16 or int8 table
  (``csrc/rerank.cu``), and the pq4 and pq codecs and the token-major sq
  probe;
* the second stage: hard-negative mining (``evaluation/dureader.py``), the
  cross-encoder reranker (``models/ce.py``) and its trainer
  (``training/ce_trainer.py``, dropout by the same Philox kernel);
* flash attention (``csrc/flash_attention.cu``) in bf16, fp16 and fp32,
  data-parallel training and corpus-sharded serving (``parallel/``,
  ``ranking/sharded.py``);
* DPR-style single-vector retrieval (``ranking/dense.py`` over
  ``indexing/flat.py``), the pooling helpers (``ops/pooling.py``) and the
  real-text docstring corpus (``evaluation/pydocs.py``) with a learned
  WordPiece vocab (``tokenization/vocab.py::train_wordpiece``).

The package imports ``torch`` and nothing of ``colbert_tpu``, ``jax`` or
``flax``: it carries its own copies of the framework-free modules (config,
vocab, punctuation, metrics, io, logging, pydocs).
"""

from colbert_tpu_torch.version import __version__


def __getattr__(name):
    """Lazy top-level API (keeps ``import colbert_tpu_torch`` free of torch startup)."""
    api = {
        "ColbertConfig": ("colbert_tpu_torch.config", "ColbertConfig"),
        "load_config": ("colbert_tpu_torch.config", "load_config"),
        "ColbertTokenizer": ("colbert_tpu_torch.tokenization", "ColbertTokenizer"),
        "ColbertModel": ("colbert_tpu_torch.models.colbert", "ColbertModel"),
        "CrossEncoderModel": ("colbert_tpu_torch.models.ce", "CrossEncoderModel"),
        "CollectionEncoder": ("colbert_tpu_torch.indexing.encoder", "CollectionEncoder"),
        "IndexStorage": ("colbert_tpu_torch.indexing.storage", "IndexStorage"),
        "IndexBuilder": ("colbert_tpu_torch.indexing.builder", "IndexBuilder"),
        "FlatIndex": ("colbert_tpu_torch.indexing.flat", "FlatIndex"),
        "ColbertSearcher": ("colbert_tpu_torch.ranking.searcher", "ColbertSearcher"),
        "RetrievalService": ("colbert_tpu_torch.serving.server", "RetrievalService"),
        "RetrievalServer": ("colbert_tpu_torch.serving.server", "RetrievalServer"),
        "RetrievalClient": ("colbert_tpu_torch.serving.server", "RetrievalClient"),
        "ColbertTrainer": ("colbert_tpu_torch.training.trainer", "ColbertTrainer"),
        "RetrievalDataset": ("colbert_tpu_torch.training.dataset", "RetrievalDataset"),
        "CETrainer": ("colbert_tpu_torch.training.ce_trainer", "CETrainer"),
    }
    if name in api:
        import importlib

        mod, attr = api[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'colbert_tpu_torch' has no attribute {name!r}")


__all__ = [
    "__version__", "ColbertConfig", "load_config", "ColbertTokenizer",
    "ColbertModel", "CrossEncoderModel", "CollectionEncoder", "IndexBuilder", "IndexStorage", "FlatIndex",
    "ColbertSearcher",
    "RetrievalService", "RetrievalServer", "RetrievalClient",
    "ColbertTrainer", "RetrievalDataset", "CETrainer",
]

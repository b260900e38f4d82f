"""colbert-tpu-torch: the PyTorch/CUDA port of ``colbert_tpu`` for NVIDIA Hopper.

A second package beside the JAX one, mirroring its module names so each
counterpart is easy to find.  The JAX package stays the reference: every
module here is tested against it on the CPU (``tests/test_torch_*.py``).

This slice covers exact flat serving: tokenizer -> BERT + ColBERT head ->
hand-written CUDA MaxSim scan (``csrc/flat_scan.cu``) -> two-stage top-k ->
the reference's socket protocol, plus the corpus encoder that writes the
part files flat mode serves from.

The package imports ``torch`` and never ``jax``/``flax``.  It shares only
the framework-free modules of ``colbert_tpu`` (config, vocab, punctuation,
metrics, io, logging).
"""

from colbert_tpu.version import __version__


def __getattr__(name):
    """Lazy top-level API (keeps ``import colbert_tpu_torch`` free of torch startup)."""
    api = {
        "ColbertConfig": ("colbert_tpu.config", "ColbertConfig"),
        "load_config": ("colbert_tpu.config", "load_config"),
        "ColbertTokenizer": ("colbert_tpu_torch.tokenization", "ColbertTokenizer"),
        "ColbertModel": ("colbert_tpu_torch.models.colbert", "ColbertModel"),
        "CollectionEncoder": ("colbert_tpu_torch.indexing.encoder", "CollectionEncoder"),
        "IndexStorage": ("colbert_tpu_torch.indexing.storage", "IndexStorage"),
        "ColbertSearcher": ("colbert_tpu_torch.ranking.searcher", "ColbertSearcher"),
        "RetrievalService": ("colbert_tpu_torch.serving.server", "RetrievalService"),
        "RetrievalServer": ("colbert_tpu_torch.serving.server", "RetrievalServer"),
        "RetrievalClient": ("colbert_tpu_torch.serving.server", "RetrievalClient"),
    }
    if name in api:
        import importlib

        mod, attr = api[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'colbert_tpu_torch' has no attribute {name!r}")


__all__ = [
    "__version__", "ColbertConfig", "load_config", "ColbertTokenizer",
    "ColbertModel", "CollectionEncoder", "IndexStorage", "ColbertSearcher",
    "RetrievalService", "RetrievalServer", "RetrievalClient",
]

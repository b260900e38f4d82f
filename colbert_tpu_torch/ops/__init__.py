"""The port's kernels and their plain versions; the pooling helpers, as
``colbert_tpu/ops/__init__.py`` exports them."""

from colbert_tpu_torch.ops.pooling import avg_pool_by_mask, batch_index_select, max_pool_by_mask, span_mean

__all__ = ["batch_index_select", "span_mean", "max_pool_by_mask", "avg_pool_by_mask"]

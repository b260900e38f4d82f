from colbert_tpu_torch.evaluation.metrics import eval_retrieval, mrr_at_k, recall_at_k
from colbert_tpu_torch.evaluation.dureader import (
    load_tsv_corpus,
    gen_ce_data,
    gen_distill_data,
    gen_iter_train_dev,
    gen_dev_for_ce_test,
)
from colbert_tpu_torch.evaluation.pydocs import DocEntry, build_retrieval_dataset, collect_docstrings, train_dev_split

__all__ = [
    "eval_retrieval",
    "mrr_at_k",
    "recall_at_k",
    "load_tsv_corpus",
    "gen_ce_data",
    "gen_distill_data",
    "gen_iter_train_dev",
    "gen_dev_for_ce_test",
    "DocEntry",
    "collect_docstrings",
    "build_retrieval_dataset",
    "train_dev_split",
]

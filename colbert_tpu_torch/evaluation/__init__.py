from colbert_tpu_torch.evaluation.dureader import load_tsv_corpus
from colbert_tpu_torch.evaluation.metrics import eval_retrieval

__all__ = ["eval_retrieval", "load_tsv_corpus"]

from colbert_tpu_torch.training.dataset import RetrievalDataset, RetrievalSampler, TrainBatch
from colbert_tpu_torch.training.trainer import ColbertTrainer

__all__ = ["ColbertTrainer", "RetrievalDataset", "RetrievalSampler", "TrainBatch"]

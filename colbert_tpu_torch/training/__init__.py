from colbert_tpu_torch.training.ce_trainer import CETrainer
from colbert_tpu_torch.training.dataset import RetrievalDataset, RetrievalSampler, TrainBatch
from colbert_tpu_torch.training.trainer import ColbertTrainer

__all__ = ["CETrainer", "ColbertTrainer", "RetrievalDataset", "RetrievalSampler", "TrainBatch"]

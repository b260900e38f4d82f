from colbert_tpu_torch.tokenization.tokenizer import ColbertTokenizer, TokenBatch, WordPieceTokenizer
from colbert_tpu_torch.tokenization.vocab import build_vocab, train_wordpiece, write_vocab

__all__ = ["ColbertTokenizer", "TokenBatch", "WordPieceTokenizer", "build_vocab", "train_wordpiece", "write_vocab"]

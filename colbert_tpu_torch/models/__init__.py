"""BERT encoder and ColBERT bi-encoder (inference), plus checkpoint conversion."""

"""On-disk index layout, the corpus encoder and the IVF index builder."""

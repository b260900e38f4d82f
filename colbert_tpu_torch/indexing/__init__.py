"""On-disk index layout and the corpus encoder."""

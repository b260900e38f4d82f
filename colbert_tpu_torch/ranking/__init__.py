"""Searcher: query encode -> flat MaxSim scan, or IVF probe -> dedup -> rerank -> top-k."""

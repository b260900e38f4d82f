"""Searcher: query encode -> flat MaxSim scan -> top-k."""

"""Structured logging and span timers: the port's copy of the framework-free
half of ``colbert_tpu/utils/logging.py`` (no profiler hook).

Loggers live under ``colbert_tpu_torch``; ``COLBERT_TPU_LOGLEVEL`` sets the level.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import time
from typing import Dict, Iterator

_FORMAT = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"
_ROOT = "colbert_tpu_torch"
_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%b %d, %H:%M:%S"))
    root = logging.getLogger(_ROOT)
    root.addHandler(handler)
    level = os.environ.get("COLBERT_TPU_LOGLEVEL", "INFO").upper()
    root.setLevel(getattr(logging, level, logging.INFO))
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


class Timers:
    """Named wall-clock span accumulator; JSON-serializable."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "count": self.counts[k], "mean_s": self.totals[k] / max(1, self.counts[k])}
            for k in self.totals
        }

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf8") as f:
            json.dump(self.as_dict(), f, indent=2)

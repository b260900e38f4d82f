"""JSON / JSONL IO helpers: the port's copy of ``colbert_tpu/utils/io.py``."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Iterable, List


def load_json(path: str | Path, line: bool = False) -> Any:
    if line:
        return load_jsonl(path)
    with open(path, "r", encoding="utf8") as f:
        return json.load(f)


def dump_json(obj: Any, path: str | Path, line: bool = False, indent: int | None = None) -> None:
    if line:
        dump_jsonl(obj, path)
        return
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf8") as f:
        json.dump(obj, f, ensure_ascii=False, indent=indent)


def load_jsonl(path: str | Path) -> List[Any]:
    with open(path, "r", encoding="utf8") as f:
        return [json.loads(l) for l in f if l.strip()]


def dump_jsonl(rows: Iterable[Any], path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", encoding="utf8") as f:
        for r in rows:
            f.write(json.dumps(r, ensure_ascii=False) + "\n")

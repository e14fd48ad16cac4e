"""Structured per-step / per-epoch metric logging.

Copy of text_guided_face_recognition_tpu/utils/logging.py. The reference
only prints loss aggregates to stdout (reference:
src/train_encoders_bert.py:102-119); here every trainer also appends
structured JSONL records (with a `ts`) when given a path, and echoes
`k v | k v` with floats rounded to 6 places. Under a process group only
rank 0 writes or echoes (parallel/mesh.py).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from text_guided_face_recognition_tpu_torch.parallel import mesh

__all__ = ["MetricLogger"]


class MetricLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path and mesh.is_main():
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, record: Dict[str, Any]) -> None:
        if not mesh.is_main():
            return
        record = dict(record)
        record.setdefault("ts", time.time())
        if self._fh is not None:
            self._fh.write(json.dumps(record, default=float) + "\n")
            self._fh.flush()
        if self.echo:
            shown = {k: (round(v, 6) if isinstance(v, float) else v)
                     for k, v in record.items() if k != "ts"}
            print(" | ".join(f"{k} {v}" for k, v in shown.items()))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

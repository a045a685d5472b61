"""Append-only JSONL metrics log with wall-clock stamps, a copy of the JAX
package's utils/metrics.py:13-33."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    """One JSON object a line: {"event", "t" (s since start), fields...}."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._t0 = time.time()
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w"):  # truncate a previous run
                pass

    def log(self, event: str, **fields: Any) -> None:
        if not self.path:
            return
        rec: Dict[str, Any] = {"event": event,
                               "t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "item") else v)
                    for k, v in fields.items()})
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

"""Scalar training statistics, numpy only.

Port of `gnerf_tpu/utils/stats.py::Collector`: each metric accumulates a
[count, sum, sum-of-squares] triple on the host; `update()` turns the deltas
since the last call into mean / std, and `write_jsonl` streams them to
stats.jsonl. Values may be numbers, numpy arrays or tensors on any device.
"""

from __future__ import annotations

import json
import re
import time
from typing import Any, Mapping, Optional

import numpy as np


def _host(value) -> np.ndarray:
    if hasattr(value, "detach"):  # a torch tensor
        value = value.detach().float().cpu().numpy()
    return np.asarray(value, dtype=np.float64)


class Collector:
    """Accumulates moment triples on the host and reports mean / std."""

    def __init__(self, regex: str = ".*"):
        self.regex = re.compile(regex)
        self._totals: dict[str, np.ndarray] = {}
        self._deltas: dict[str, np.ndarray] = {}
        self._last: dict[str, dict] = {}

    def report(self, name: str, value) -> None:
        """Accumulate a scalar or tensor of raw values."""
        flat = _host(value).reshape(-1)
        self._fold(name, np.array([flat.size, flat.sum(), (flat * flat).sum()]))

    def report_moments(self, name: str, triple) -> None:
        """Accumulate a precomputed [n, sum, sum_sq] triple."""
        triple = _host(triple)
        assert triple.shape == (3,)
        self._fold(name, triple)

    def _fold(self, name: str, m: np.ndarray) -> None:
        for store in (self._totals, self._deltas):
            store[name] = store.get(name, np.zeros(3)) + m

    def update(self) -> dict[str, dict]:
        """Flush deltas -> {name: {num, mean, std}}."""
        out = {}
        for name, m in self._deltas.items():
            if not self.regex.fullmatch(name):
                continue
            n, s, ss = m
            mean = s / max(n, 1)
            var = max(ss / max(n, 1) - mean * mean, 0.0)
            out[name] = {"num": int(n), "mean": float(mean), "std": float(np.sqrt(var))}
        self._deltas = {}
        self._last = out
        return out

    def as_dict(self) -> dict[str, dict]:
        return dict(self._last)

    def write_jsonl(self, path: str, extra: Optional[Mapping[str, Any]] = None) -> None:
        entry = {k: v for k, v in self.as_dict().items()}
        entry["timestamp"] = time.time()
        if extra:
            entry.update(extra)
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")

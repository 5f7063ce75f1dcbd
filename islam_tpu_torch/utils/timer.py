"""Named tic/toc wall-clock timer (a copy of ``islam_tpu/utils/timer.py``,
reference timer.py:3-48)."""

from __future__ import annotations

import time
from collections import defaultdict


class Timer:
    def __init__(self):
        self._start = {}
        self._hist = defaultdict(list)

    def tic(self, name: str):
        self._start[name] = time.perf_counter()

    def toc(self, name: str) -> float:
        if name not in self._start:
            return 0.0
        dt = time.perf_counter() - self._start[name]
        self._hist[name].append(dt)
        return dt

    def last(self, name: str) -> float:
        h = self._hist.get(name)
        return h[-1] if h else 0.0

    def avg(self, name: str) -> float:
        h = self._hist.get(name)
        return sum(h) / len(h) if h else 0.0

    def tot(self, name: str) -> float:
        return sum(self._hist.get(name, []))

"""Wall-clock phase timers: compile / execute dispatch / device_get.

PERF.md's correction history is a catalog of mistaking one phase for
another — the ~90-130 ms fixed `device_get` sync being billed to the
scan, warmup compile leaking into timed reps. The PhaseTimer makes the
split explicit: bench.py and the obs CLI bracket each phase, and the
resulting report travels with every benchmark capture so a headline
number can always be decomposed.

Host-side by construction (time.perf_counter); never used in traced
code.

The port's copy of the JAX package's ``obs/phases.py``, unchanged apart
from its import paths.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, Iterator, List


class PhaseTimer:
    """Accumulates named wall-clock phases.

    Phases are additive: entering the same name again adds to its
    total (so per-rep dispatch/sync costs aggregate naturally).
    Insertion order is preserved in the report.
    """

    # lint: host
    def __init__(self) -> None:
        self._total: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._order: List[str] = []
        self._attached: Dict[str, object] = {}

    # lint: host
    def attach(self, key: str, doc) -> None:
        """Attach a non-timing section (JSON-serializable) that rides
        in the report — obs.profiler uses this to fold per-kernel
        compiled cost attribution next to the wall-clock phases."""
        self._attached[str(key)] = doc

    # lint: host
    def add(self, name: str, seconds: float) -> None:
        """Credit `seconds` to phase `name` (for spans measured with
        an existing perf_counter pair, e.g. inside a timed rep where
        a with-block would add its own overhead between reads)."""
        if name not in self._total:
            self._total[name] = 0.0
            self._count[name] = 0
            self._order.append(name)
        self._total[name] += float(seconds)
        self._count[name] += 1

    # lint: host
    @contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    # lint: host
    def report(self) -> dict:
        """{phase: {"seconds", "count"}} in first-entry order, plus a
        "total_seconds" rollup."""
        phases = {n: {"seconds": round(self._total[n], 6),
                      "count": self._count[n]} for n in self._order}
        doc = {"phases": phases,
               "total_seconds": round(sum(self._total.values()), 6)}
        doc.update(self._attached)
        return doc

"""Per-phase frame timing with min/avg/max aggregation.

Role-equivalent of GLTimerQueries (reference: src/GLTimerQueries.cpp:6-153):
label start/end pairs aggregated into min/avg/max stats.  The
GPU timestamp is approximated by blocking on the phase's output
(`jax.block_until_ready`), which the caller does inside the timed span
when device-accurate numbers are wanted.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class _Stat:
    count: int = 0
    total: float = 0.0
    min: float = float("inf")
    max: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.min = min(self.min, dt)
        self.max = max(self.max, dt)

    @property
    def avg(self) -> float:
        return self.total / max(self.count, 1)


class Timings:
    """start/stop label pairs -> per-label min/avg/max milliseconds."""

    def __init__(self, window: int = 0):
        self.stats: dict[str, _Stat] = defaultdict(_Stat)
        self._open: dict[str, float] = {}

    def start(self, label: str) -> None:
        self._open[label] = time.perf_counter()

    def stop(self, label: str) -> None:
        t0 = self._open.pop(label, None)
        if t0 is not None:
            self.stats[label].add((time.perf_counter() - t0) * 1e3)

    @contextmanager
    def span(self, label: str):
        self.start(label)
        try:
            yield
        finally:
            self.stop(label)

    def report(self) -> str:
        lines = [f"{'label':24s} {'min':>8s} {'avg':>8s} {'max':>8s} {'n':>5s}"]
        for label, s in sorted(self.stats.items()):
            lines.append(
                f"{label:24s} {s.min:8.3f} {s.avg:8.3f} {s.max:8.3f} {s.count:5d}"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.stats.clear()
        self._open.clear()

"""Phase timing — the reference's clock() accumulator report
(PSBA/main.cpp:26-37, 220-227) as a reusable context-manager registry."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class PhaseTimers:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = ["phase timing:"]
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(
                f"  {name:<16s} {self.totals[name]:9.3f}s"
                f"  x{self.counts[name]}"
            )
        return "\n".join(lines)

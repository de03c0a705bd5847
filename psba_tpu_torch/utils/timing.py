"""Phase timing — the reference's clock() accumulator report
(PSBA/main.cpp:26-37, 220-227) as a reusable context-manager registry —
and the LM loop's tracing: its spans, its host reads and their counters.

Tracing is on while a torch.profiler records (`tracing()`). `lm_run`
checks it once on entry. While it is on, lm_run opens `span`s around the
stages of each iteration (`psba.lm.linearize`, `.damping`, `.schur`,
`.solve`, `.step`, `.control`), `host_read` spans each host read as
`psba.read`, and the totals of `LM` move. While it is off, no span is
built and no total moves. The spans are host records on the profiler's
timeline, beside the device's records, each inside the span or record
that was open when it opened.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from contextlib import contextmanager

import torch


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


def tracing() -> bool:
    """True while a torch.profiler records: the switch of the spans and
    counters below (tens of ns a call)."""
    return torch.autograd._profiler_enabled()


# torch's C++ profiler scope (the one torch.compile's generated code
# opens): a host record named like torch.profiler.record_function's, at
# about 1 us a span under the profiler against about 8 for record_function,
# which enters through the dispatcher (CPU, torch 2.13)
span = torch._C._profiler._RecordFunctionFast

_NULL = contextlib.nullcontext()


def no_span(name: str):
    """A span that builds nothing: the stand-in for `span` while tracing
    is off."""
    return _NULL


class LMCounters:
    """lm_run's totals while tracing is on; they never reset, so a reader
    takes the difference of two readings or, as the benchmark's readers
    do, ratios of totals that only traced windows moved.

      iters    LM iterations completed
      reads    host reads through host_read
      wait_ns  ns the host spent inside those reads: its wait on the card
      run_ns   ns from entering lm_run to its return
      on       True while a traced lm_run runs (host_read counts then)
    """

    def __init__(self):
        self.iters = self.reads = self.wait_ns = self.run_ns = 0
        self.on = False


LM = LMCounters()


@contextmanager
def lm_traced():
    """Around one traced lm_run: turns host_read's counting on and adds
    the run's host time to LM.run_ns."""
    LM.on = True
    t0 = time.perf_counter_ns()
    try:
        yield LM
    finally:
        LM.run_ns += time.perf_counter_ns() - t0
        LM.on = False


def host_read(read):
    """read(), the one way the LM path moves a device value to the host
    (`.item()`, `.cpu()`) or copies one synchronously to the device: each
    waits for the card. Inside a traced lm_run the call is spanned as
    `psba.read`, counted in LM.reads, and its time added to LM.wait_ns."""
    if not LM.on:
        return read()
    with span("psba.read"):
        t0 = time.perf_counter_ns()
        out = read()
        LM.wait_ns += time.perf_counter_ns() - t0
    LM.reads += 1
    return out

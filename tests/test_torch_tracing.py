"""The LM loop's tracing (psba_tpu_torch.utils.timing): spans around the
stages of lm_run and its host reads, and the LM counters, on only while a
torch.profiler records; the benchmark's readers of those counters; and,
on the card, that lm_run waits for the device nowhere but in host_read.

The CPU tests run the plain versions on small synthetic problems. The card
test is marked `gpu` and skips without a CUDA device; run it there with

    python -m pytest tests/test_torch_tracing.py -q --noconftest

(--noconftest: tests/conftest.py sets up JAX, which this file does not
use.)
"""

import contextlib
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from psba_tpu_torch.core import schur as schur_mod
from psba_tpu_torch.io import synthetic_problem
from psba_tpu_torch.problem import BAProblem
from psba_tpu_torch.solvers import (OptState, ProblemArrays, SolverConfig,
                                    lm, resolve_damping)
from psba_tpu_torch.utils import timing

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench import trace as tr  # noqa: E402
from portbench.gen.ring import ring_problem  # noqa: E402

STAGES = ("psba.lm.linearize", "psba.lm.damping", "psba.lm.schur",
          "psba.lm.solve", "psba.lm.step", "psba.lm.control")
CALLER = "caller"


def _setup(schur, damping="additive", device="cpu", prob=None):
    prob = prob or synthetic_problem(n_cams=8, n_pts=200, seed=3)
    pa = ProblemArrays.from_problem(prob, dtype=torch.float32, device=device,
                                    schur=schur)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    cams, pts = t(prob.cams), t(prob.pts)
    cfg = resolve_damping(SolverConfig.for_dtype(
        torch.float32, lm_switch_count=10_000), pa, cams, pts)
    cfg = cfg._replace(damping=damping)
    return pa, OptState.init(pa, cams, pts), cfg


def _totals():
    L = timing.LM
    return L.iters, L.reads, L.wait_ns, L.run_ns


def _traced_run(pa, st0, cfg):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            out = lm.lm_run(pa, st0, cfg, iter_cap=3)
    return out, prof.events()


def _refuse_spans(monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name!r} built with tracing off")

    monkeypatch.setattr(timing, "span", refuse)


@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_untraced_run_moves_no_counter_and_builds_no_span(schur,
                                                          monkeypatch):
    pa, st0, cfg = _setup(schur)
    _refuse_spans(monkeypatch)
    before = _totals()
    out = lm.lm_run(pa, st0, cfg, iter_cap=3)
    assert out.itno == 3
    assert _totals() == before and not timing.LM.on


@pytest.mark.parametrize("schur,damping", [
    ("dense", "additive"), ("dense", "marquardt"), ("pairs", "additive")])
def test_traced_run_counts_iterations_and_reads(schur, damping):
    """One read on entry, the additive first damping's max diagonal, two a
    try (inv3x3_planar3's fallback test and the try's scalars), one on
    exit."""
    pa, st0, cfg = _setup(schur, damping)
    iters, reads, wait_ns, run_ns = _totals()
    out, events = _traced_run(pa, st0, cfg)
    tries = sum(e.name == "psba.lm.control" for e in events)
    assert out.itno == 3 and tries >= 3
    expect = 1 + (damping == "additive") + 2 * tries + 1
    L = timing.LM
    assert (L.iters - iters, L.reads - reads) == (3, expect)
    assert sum(e.name == "psba.read" for e in events) == expect
    assert 0 < L.wait_ns - wait_ns < L.run_ns - run_ns
    assert not L.on


@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_traced_run_gives_the_same_bits(schur):
    pa, st0, cfg = _setup(schur)
    a = lm.lm_run(pa, st0, cfg, iter_cap=3)
    b, _ = _traced_run(pa, st0, cfg)
    assert torch.equal(a.cams, b.cams) and torch.equal(a.pts, b.pts)
    assert (a.itno, a.flag) == (b.itno, b.flag)
    assert torch.equal(a.ex_l2, b.ex_l2)


def test_spans_nest_under_the_caller_and_their_stage():
    pa, st0, cfg = _setup("dense")
    _, events = _traced_run(pa, st0, cfg)
    parent = lambda e: e.cpu_parent.name if e.cpu_parent else None
    names = {e.name for e in events}
    assert set(STAGES) <= names
    for e in events:
        if e.name in STAGES:
            assert parent(e) == CALLER, e.name
    reads = [parent(e) for e in events if e.name == "psba.read"]
    # entry and exit under the caller, the first damping's max diagonal,
    # then per try the fallback test in the Schur stage and the scalars in
    # the step
    assert reads == [CALLER, "psba.lm.damping"] + [
        "psba.lm.schur", "psba.lm.step"] * 3 + [CALLER]


def test_reads_outside_lm_run_are_not_counted():
    """host_read counts only inside a traced lm_run: the TR phase's
    inverse (inv3x3 -> inv3x3_planar3) reads, but not into LM."""
    V = torch.eye(3).expand(5, 3, 3).contiguous()
    before = _totals()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _vinv, ok = schur_mod.inv3x3(V)
    assert bool(ok) and _totals() == before
    assert not any(e.name == "psba.read" for e in prof.events())


def test_metric_readers_from_set_totals(monkeypatch):
    read = lambda name: harness.metric_reader(name).read({})
    L = timing.LMCounters()
    monkeypatch.setattr(timing, "LM", L)
    for n in ("lm_wait_ms", "lm_host_ms", "lm_reads_per_iter"):
        for split in ("dense", "pairs"):
            assert read(f"{n}.{split}") is None
    L.iters, L.reads, L.wait_ns, L.run_ns = 6, 18, 600_000_000, 630_000_000
    assert read("lm_wait_ms.pairs") == pytest.approx(100.0)
    assert read("lm_host_ms.pairs") == pytest.approx(5.0)
    assert read("lm_reads_per_iter.dense") == pytest.approx(3.0)
    # a program without the counters gives nothing and does not raise
    monkeypatch.delattr(timing, "LM")
    assert read("lm_wait_ms.dense") is None


def test_idle_inside_a_read_is_named_after_the_read():
    h = lambda n, s, e: dict(name=n, device=False, start=s, end=e)
    host = [h("lm_run", 0.0, 1000.0), h("psba.lm.step", 100.0, 500.0),
            h("psba.read", 300.0, 450.0), h("psba.lm.control", 500.0, 520.0)]
    assert tr.host_activity(host, [350.0, 200.0, 510.0, 700.0, 1200.0]) == [
        "psba.read", "psba.lm.step", "psba.lm.control", "lm_run", "python"]
    d = lambda n, s, e: dict(name=n, device=True, start=s, end=e)
    recs = [h(harness.WINDOW, 0.0, 1000.0)] + host + [
        d("kernel", 0.0, 300.0), d("kernel", 450.0, 1000.0)]
    gaps = dict(tr.reduce_trace(recs, harness.WINDOW)["breakdown"]
                ["idle_gaps"])
    assert gaps == {"psba.read": pytest.approx(150e-6)}


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [False, True], ids=["off", "traced"])
@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_card_syncs_only_in_host_read(schur, traced, monkeypatch):
    """With CUDA's sync debug mode at "error", any synchronization that
    does not go through host_read raises. The pair problem is the
    benchmark's ring at 180 cameras, so S (n = 1,080) goes to cholesky_ex
    as Final-961's does. One run first loads the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    real = timing.host_read

    def lifted(read):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(read)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    monkeypatch.setattr(lm, "host_read", lifted)
    monkeypatch.setattr(schur_mod, "host_read", lifted)
    if schur == "pairs":
        assumed = json.loads((ROOT / "portbench" / "configs" /
                              "final961.json").read_text())["assumed"]
        prob = BAProblem(**ring_problem(180, 3000, 15_000, 3, "cuda",
                                        assumed))
    else:
        prob = synthetic_problem(n_cams=13, n_pts=700, seed=3)
    pa, st0, cfg = _setup(schur, device="cuda", prob=prob)
    ref = lm.lm_run(pa, st0, cfg, iter_cap=3)
    torch.cuda.synchronize()
    tracer = (profile(activities=[ProfilerActivity.CPU]) if traced
              else contextlib.nullcontext())
    with tracer:
        torch.cuda.set_sync_debug_mode("error")
        try:
            # the mode sees a read that does not go through host_read
            with pytest.raises(RuntimeError):
                st0.ex_l2.item()
            out = lm.lm_run(pa, st0, cfg, iter_cap=3)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert out.itno == 3 and torch.equal(out.cams, ref.cams)

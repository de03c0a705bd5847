"""The metric arithmetic on a made-up trace: the idle share from a union of
intervals, device time by name, the breakdown, and a roofline share that
stays at or under 100%."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness, peaks  # noqa: E402
from portbench import trace as tr  # noqa: E402


def metric(name):
    return harness.metric_reader(name)


def made_up_trace():
    """A 1000 us window; kernels overlapping at 100-300 and 250-400, a copy
    at 600-700 and a kernel half outside the window; host ops around."""
    d = lambda n, s, e: dict(name=n, device=True, start=s, end=e)
    h = lambda n, s, e: dict(name=n, device=False, start=s, end=e)
    return [
        h(harness.WINDOW, 0.0, 1000.0),
        h("lm_run", 0.0, 950.0),
        h("aten::_local_scalar_dense", 420.0, 580.0),
        d("(anonymous namespace)::spd_solve_kernel(float const*, int)",
          100.0, 300.0),
        d("ampere_sgemm_128x64_nn", 250.0, 400.0),
        d("Memcpy DtoH (Device -> Pageable)", 600.0, 700.0),
        d("ampere_sgemm_128x64_nn", 900.0, 1100.0),
    ]


def test_union_and_gaps():
    busy = tr.union([(100, 300), (250, 400), (600, 700), (900, 1100)],
                    0, 1000)
    assert busy == [[100, 400], [600, 700], [900, 1000]]
    assert tr.gaps(busy, 0, 1000) == [(0, 100), (400, 600), (700, 900)]
    assert tr.union([(5, 5), (7, 3)], 0, 10) == []


def test_reduce_trace_idle_and_names():
    red = tr.reduce_trace(made_up_trace(), harness.WINDOW)
    assert red["window_s"] == pytest.approx(1e-3)
    assert red["busy_s"] == pytest.approx(500e-6)        # 300 + 100 + 100
    assert red["device_ms"]["ampere_sgemm_128x64_nn"] == pytest.approx(0.25)
    gaps = dict(red["breakdown"]["idle_gaps"])
    assert gaps["aten::_local_scalar_dense"] == pytest.approx(200e-6)
    assert gaps["lm_run"] == pytest.approx(300e-6)        # 0-100, 700-900
    ops = red["breakdown"]["device_ops"]
    assert ops[0][0] == "ampere_sgemm_128x64_nn" and len(ops) == 3
    rec = dict(iters=2, window_s=red["window_s"],
               busy_s=red["busy_s"], device_ms=red["device_ms"],
               counters={"spd_solve": 1, "gain_dense": 2}, kernels={})
    assert metric("device_idle.dense").read(rec) == pytest.approx(50.0)
    assert metric("lm_tries_per_iter.pairs").read(rec) == pytest.approx(1.0)


def test_kernel_names_match_namespaced_and_template_records():
    assert tr.is_kernel("(anonymous namespace)::spd_solve_kernel(float*)",
                        "spd_solve_kernel")
    assert tr.is_kernel("void ns::gain_dense_kernel<4>(float*)",
                        "gain_dense_kernel")
    assert not tr.is_kernel("(anonymous namespace)::linearize_dense_finish_"
                            "kernel(float*)", "linearize_dense_kernel")


def test_roofline_share_never_over_100():
    ks = harness.kernel_files()
    shape = dict(C=138, P=19878, O=79474)
    kernels = {}
    for n in ("linearize_dense", "spd_solve", "gain_dense"):
        nbytes, flops = ks[n].work(shape)
        b = peaks.bound_ms(nbytes, flops)
        # a kernel running exactly at its bound reads 100%, never more
        kernels[n] = dict(launches=3, bound_ms=3 * b, device_ms=3 * b)
    rec = dict(iters=3, kernels=kernels, device_ms={},
               counters={})
    assert metric("kernels_roofline.dense").read(rec) == pytest.approx(
        100.0)
    kernels["spd_solve"]["device_ms"] *= 50
    assert metric("kernels_roofline.dense").read(rec) < 100.0
    rec["device_ms"] = {"x": sum(k["device_ms"] for k in kernels.values())
                        + 6.0}
    assert metric("core_device_ms.pairs").read(rec) == pytest.approx(2.0)


def test_readers_find_nothing_and_return_nothing():
    rec = dict(iters=0, window_s=0.0, busy_s=0.0, kernels={},
               device_ms={}, counters={})
    for name in ("kernels_roofline", "device_idle", "lm_tries_per_iter",
                 "core_device_ms"):
        assert metric(name).read(rec) is None


def test_bounds_of_the_dense_lm_kernels():
    """Bytes and operations from the shapes, at the data sheet's peaks:
    spd_solve at n = 828 is bound by its operations."""
    ks = harness.kernel_files()
    nbytes, flops = ks["spd_solve"].work(dict(C=138, P=1, O=1))
    assert flops == pytest.approx(828 ** 3 / 3 + 2 * 828 ** 2)
    assert peaks.bound_ms(nbytes, flops) == pytest.approx(
        1e3 * flops / 67e12)


@pytest.mark.parametrize("shape", [dict(C=961, P=187103, O=1692975),
                                   dict(C=138, P=19878, O=85217)])
def test_linearize_stream_parts_sum_to_a_whole_call(shape):
    """The camera pass and the point pass, each in its own file with its
    own counter: bytes and operations add up to a whole call's with the
    pair LM flags (57 C + 15 P + 24 O + 1 floats, 531 operations an
    observation), and both are bound by their bytes, so a launch of both
    has the bound of the whole call."""
    kernels = harness.kernel_files()
    cam, pts = kernels["linearize_stream"], kernels["linearize_stream_points"]
    assert cam.RECORDS == ("linearize_stream_kernel",)
    assert pts.RECORDS == ("linearize_stream_points_kernel",)
    assert not tr.is_kernel("linearize_stream_points_kernel",
                            "linearize_stream_kernel")
    assert cam.COUNTER[2] == "launches" and pts.COUNTER[2] == "point_launches"
    C, P, O = shape["C"], shape["P"], shape["O"]
    (b1, f1), (b2, f2) = cam.work(shape), pts.work(shape)
    assert b1 + b2 == 4 * (57 * C + 15 * P + 24 * O + 1)
    assert f1 + f2 == 531 * O
    assert peaks.bound_ms(b1, f1) + peaks.bound_ms(b2, f2) == pytest.approx(
        peaks.bound_ms(b1 + b2, f1 + f2), rel=1e-12)
    assert harness.read_counter(pts.COUNTER) >= 0

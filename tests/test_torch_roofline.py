"""The port's roofline model (psba_tpu_torch.utils.roofline) against the
reference's (psba_tpu.utils.roofline).

Operation counts equal the reference's where the work is the same (the
stages below; the port counts the planar width Pp, P padded to the
128-point tile, where the reference counts the P it is given, so the
reference is asked at Pp); the card's peaks are the H100's, which
chip_smoke.py's bounds read; summarize refuses a non-positive time as the
reference's does (tests/test_utils.py).
"""

import pytest

from psba_tpu.utils import roofline as jr
from psba_tpu_torch.utils import roofline as tr

SHAPES = [(21, 11315, 36455), (138, 19211, 2467416), (7, 128, 1916)]
SAME_WORK = ("schur_S_dense", "reduced_rhs_dense", "back_substitute",
             "inv3x3", "spd_solve")


@pytest.mark.parametrize("C,P,O", SHAPES)
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_flops_match_reference(C, P, O, precision):
    """The operation counts are the reference's, and the S products run at
    the float32 rate under either precision (the port runs "high" in
    float32)."""
    got = tr.lm_stage_costs(C, P, O)
    ref = jr.lm_stage_costs(C, tr.padded_points(P), O)
    for name in SAME_WORK:
        assert got[name].flops_matmul == ref[name].flops_mxu, name
        assert got[name].flops_elem == ref[name].flops_vpu, name
        assert got[name].seq_steps == ref[name].seq_steps, name
        assert (got[name].terms(tr.H100, precision)["matmul"]
                == got[name].flops_matmul / 67e12), name
    assert tr.OUTER_STAGES == jr.OUTER_STAGES
    assert tr.RETRY_STAGES == jr.RETRY_STAGES


def test_h100_peaks_and_precision_rates():
    h = tr.H100
    assert (h.hbm_gbps, h.f32_tflops) == (3350.0, 67.0)
    assert h.matmul_tflops("highest") == h.matmul_tflops("high") == 67.0
    with pytest.raises(ValueError):
        h.matmul_tflops("default")
    # no TPU entry in the port
    assert not any(isinstance(v, tr.ChipPeaks) and v is not h
                   for v in vars(tr).values())


def test_high_costs_as_highest():
    """"high" runs the same float32 work as "highest" on the card, so the
    iteration's roofline is the same at both."""
    C, P, O = 138, 19211, 2467416
    lo = tr.lm_iter_roofline(C, P, O, precision="highest")
    hi = tr.lm_iter_roofline(C, P, O, precision="high")
    assert hi.stage_ms == lo.stage_ms and hi.total_ms == lo.total_ms
    assert (hi.bytes, hi.flops_matmul, hi.bound) == (lo.bytes,
                                                     lo.flops_matmul,
                                                     lo.bound)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_summarize_rejects_invalid_measurement(precision):
    with pytest.raises(ValueError):
        tr.summarize(21, 11315, 36455, -0.028, precision=precision)
    with pytest.raises(ValueError):
        tr.summarize(21, 11315, 36455, 0.0, precision=precision)
    out = tr.summarize(21, 11315, 36455, 0.25, precision=precision)
    ref = jr.summarize(21, 11315, 36455, 0.25)
    assert set(out) == set(ref)
    assert out["mfu"] > 0 and out["hbm_frac"] > 0 and out["sol_frac"] > 0
    assert out["chip"] == tr.H100.name
    r = tr.lm_iter_roofline(21, 11315, 36455, precision=precision)
    assert out["roofline_iter_ms"] == round(r.total_ms, 4)
    assert r.total_ms == pytest.approx(sum(r.stage_ms.values()))

"""The control of the check: the plain reference put in the program's
place and computed one precision below the configuration's (float32 with
TF32 products, where the configuration states float32 with TF32 off) comes
out as not correct, at a size a test run holds; the program at that size
comes out correct. (On the card, at the cells' own sizes, the readings are
taken by portbench/calibrate.py.)"""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.gen.ring import ring_problem  # noqa: E402


@pytest.mark.parametrize("name, C, P, O, schur", [
    ("ladybug138.lm", 40, 3000, 12861, "dense"),
    ("final961.lm", 24, 2500, 15000, "pairs"),
])
def test_control_fails_program_passes(name, C, P, O, schur):
    spec = copy.deepcopy(harness.cell(name))
    cfg, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    drv = harness.driver(spec)
    cfg.update(n_cams=C, n_pts=P, n_obs=O, schur=schur)
    a = ring_problem(C, P, O, 4_000_000_017, "cpu", cfg["assumed"])
    check = drv.Check(a, cfg, traffic, "cpu")
    control = drv.Check(a, cfg, traffic, "cpu", matmul="tf32",
                        dtype="float32")
    checks, failed = harness.judge(check, [control.as_answer()], limits)
    assert failed == 1, checks
    prog = drv.Program(a, cfg, traffic, "cpu")
    checks, failed = harness.judge(check, [prog.answer(prog.keep(
        prog.step()))], limits)
    assert failed == 0, checks


def test_tf32_rounding():
    import torch

    from portbench.reference.lm import round_tf32

    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0,
                                      1.0 + 2 ** -9, -3.0]


def test_settings_of_the_lm_cells_unchanged():
    """lm_repeats' reference settings by the configuration's dtype: the
    two float32 LM cells get what they got before float64 had room."""
    spec = harness.cell("final961.lm")
    drv = harness.driver(spec)
    for name in ("ladybug138.lm", "final961.lm"):
        s = harness.cell(name)
        assert drv.reference_settings(s["traffic"], s["config"]["dtype"]) \
            == dict(tau=1e-3, stop_thresh=1e-6, max_inner=64,
                    lm_switch_count=51, iters=3)
    f64 = drv.reference_settings(spec["traffic"], "float64")
    assert f64["stop_thresh"] == 1e-12

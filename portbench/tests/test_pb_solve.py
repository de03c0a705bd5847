"""The cell ladybug138.solve on the CPU at small sizes: the plain reference
of the hybrid solve against the program (on BAL data, both encodings), its
GMW against the program's, and whole runs of the cell on its dense
encoding (the look for a card skipped) that come out correct, and not
correct with the timed path broken underneath. (The exchange between
cards does not exist in a one-card cell.)

    python -m pytest portbench/tests/test_pb_solve.py -q
"""

import copy
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.gen.ring import ring_problem  # noqa: E402
from portbench.reference import hybrid  # noqa: E402
from portbench.reference import lm as ref  # noqa: E402

NAME = "ladybug138.solve"
# cameras, points, observations: the cell's views per point, and enough
# points that 14 iterations stay above float32's noise floor, where the
# stop tests and TR's rho read rounding
SMALL = dict(n_cams=40, n_pts=3000, n_obs=12861, schur="dense")
SEED = 987654321987


def small_spec(**config):
    spec = copy.deepcopy(harness.cell(NAME))
    spec["config"].update(SMALL, **config)
    return spec


def run(seed=SEED):
    return harness.run_cell(NAME, seed, 0.2, False, time.perf_counter(),
                            device="cpu", spec=small_spec(),
                            log=lambda *a: None)


def pin_bootstrap(monkeypatch, lam):
    """The program's TR bootstraps lambda = `lam` instead of its GMW's."""
    from psba_tpu_torch.solvers import tr

    monkeypatch.setattr(tr, "gmw_bootstrap_lambda",
                        lambda S: torch.tensor(lam, dtype=S.dtype))


@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_reference_follows_the_program_in_float64(monkeypatch, schur):
    """BAL data (tests/data/mini_bal.txt) in float64, 50 iterations: LM,
    TR, back to LM, TR. The bootstrapped lambda is rounding noise on both
    sides, so the program's is pinned and the reference takes it from the
    program's history; everything else each side works out itself."""
    from psba_tpu_torch.io import bal_to_problem

    pin_bootstrap(monkeypatch, 10.0)
    p = bal_to_problem(str(ROOT / "tests" / "data" / "mini_bal.txt"))
    arrays = {k: getattr(p, k) for k in ("K", "q0", "cams", "pts", "obs",
                                         "cam_idx", "pt_idx")}
    spec = small_spec(n_cams=p.n_cams, n_pts=p.n_pts, n_obs=p.n_obs,
                      dtype="float64", schur=schur)
    spec["traffic"]["solver"]["max_iters"] = 50
    drv = harness.driver(spec)
    prog = drv.Program(arrays, spec["config"], spec["traffic"], "cpu")
    a = prog.answer(prog.keep(prog.step()))
    check = drv.Check(arrays, spec["config"], spec["traffic"], "cpu")
    nums = check.numbers(a)
    names = [name for name, _, _ in a["phases"]]
    assert names[:4] == ["lm", "tr", "lm", "tr"], a["phases"]
    assert list(a["phases"]) == list(check.summary["phases"])
    assert a["itno"] == check.summary["iters"]
    assert a["flag"] == check.summary["flag"]
    assert len(a["boots"]) >= 2
    assert [how for _, _, how in check.summary["boots"]] == ["given"] * len(
        a["boots"])
    assert nums["iters_gap"] == 0.0
    np.testing.assert_allclose(a["cams"], check.cams.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(a["pts"], check.pts.numpy(), rtol=0,
                               atol=1e-9)


def gmw_matrices():
    """A ring's reduced camera system at lambda = 0 (float64) with two
    cameras' rows and columns zeroed, which fixes the gauge and leaves 12
    exactly singular pivots; and the same shifted down past some of its
    eigenvalues, so that GMW perturbs pivots that are negative by far more
    than rounding."""
    a = ring_problem(12, 500, 2500, 4_000_000_019, "cpu",
                     harness.cell(NAME)["config"]["assumed"])
    prob = ref.Problem(a, "cpu", torch.float64)
    cams = torch.as_tensor(a["cams"])
    pts = torch.as_tensor(a["pts"])
    B = hybrid.Blocks(prob, cams, pts, prob.residual(cams, pts),
                      ref.Products("exact"))
    S = B.reduced(0.0)[0]
    S[:12], S[:, :12] = 0.0, 0.0
    ev = torch.linalg.eigvalsh(S)
    return {"gauge": S,
            "indefinite": S - 0.5 * (ev[20] + ev[21]) * torch.eye(
                S.shape[0], dtype=S.dtype)}


@pytest.mark.parametrize("case", ["gauge", "indefinite"])
def test_gmw_matches_the_program(case):
    from psba_tpu_torch.core import gmw

    S = gmw_matrices()[case]
    E = hybrid.gmw_perturbation(S)
    assert (E[:12] > 0).all()
    if case == "indefinite":
        assert int((E > 1e-6 * float(E.max())).sum()) >= 12 + 10
    scale = float(E.abs().max())
    for program in (gmw.gmw_perturbation(S),
                    gmw.gmw_perturbation_blocked(S)):
        np.testing.assert_allclose(E.numpy(), program.numpy(), rtol=0,
                                   atol=1e-9 * scale)
    assert hybrid.gmw_bootstrap(S) == pytest.approx(
        float(gmw.gmw_bootstrap_lambda(S)), rel=1e-9)


@pytest.mark.gpu
def test_gmw_on_the_card_as_the_timed_path_runs_it():
    """The program's bootstrap as the timed path calls it (float32, on the
    card, blocked at the cell's n = 828) against the reference's GMW in
    float64 on the same float32 matrix: a ring's reduced camera system
    with two cameras fixed, shifted down past 20 of its eigenvalues, so
    that E sits on pivots that are negative by far more than rounding."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from psba_tpu_torch.core import gmw

    a = ring_problem(138, 3000, 12861, 4_000_000_037, "cpu",
                     harness.cell(NAME)["config"]["assumed"])
    prob = ref.Problem(a, "cpu", torch.float64)
    cams, pts = torch.as_tensor(a["cams"]), torch.as_tensor(a["pts"])
    S = hybrid.Blocks(prob, cams, pts, prob.residual(cams, pts),
                      ref.Products("exact")).reduced(0.0)[0]
    S[:12], S[:, :12] = 0.0, 0.0
    ev = torch.linalg.eigvalsh(S)
    S = (S - 0.5 * (ev[32] + ev[33]) * torch.eye(S.shape[0],
                                                 dtype=S.dtype)).float()
    assert S.shape[0] == 828 > gmw.BLOCKED_GMW_MIN_N
    E = hybrid.gmw_perturbation(S.double())
    assert int((E > 1e-3 * float(E.max())).sum()) >= 20
    on_card = gmw.gmw_perturbation_blocked(S.cuda()).double().cpu()
    np.testing.assert_allclose(on_card.numpy(), E.numpy(), rtol=0,
                               atol=1e-4 * float(E.abs().max()))
    assert float(gmw.gmw_bootstrap_lambda(S.cuda())) == pytest.approx(
        hybrid.gmw_bootstrap(S.double()), rel=1e-4)


def test_sound_solve_is_correct():
    r = run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"l2_gap", "iters_gap"}
    assert r["metrics"]["solve_s"]["value"] > 0


def test_solve_returns_its_start(monkeypatch):
    from psba_tpu_torch.solvers import hybrid as program

    orig = program.solve

    def unchanged(prob, *a, **kw):
        out = orig(prob, *a, **kw)
        out.cams, out.pts = prob.cams.copy(), prob.pts.copy()
        return out

    monkeypatch.setattr(program, "solve", unchanged)
    r = run()
    assert not r["correct"] and r["failed"] >= 1
    assert r["checks"]["l2_gap"]["value"] > r["checks"]["l2_gap"]["limit"]


def test_half_the_observations_left_out(monkeypatch):
    """Both phases' linearization see every other point's observations
    only, the camera sums doubled to stand for the mean over the rest."""
    from psba_tpu_torch.solvers import lm, tr

    stream = lm.linearize_stream

    def half_stream(K, q0, cams, pts, obs, cam_idx, pt_idx, valid, *a,
                    **kw):
        v = (pt_idx % 2 == 0).to(obs.dtype)
        out = list(stream(K, q0, cams, pts, obs, cam_idx, pt_idx, v, *a,
                          **kw))
        out[2], out[5] = 2 * out[2], 2 * out[5]
        return tuple(out)

    dense = lm.linearize_dense

    def half_dense(K, q0, cams, pts, du, dv, valid_d, **kw):
        vd = valid_d.clone()
        vd[:, 1::2] = 0.0
        out = list(dense(K, q0, cams, pts, du, dv, vd, **kw))
        if kw.get("want_u"):
            out[6], out[7] = 2 * out[6], 2 * out[7]
        return tuple(out)

    for mod in (lm, tr):
        monkeypatch.setattr(mod, "linearize_stream", half_stream)
        monkeypatch.setattr(mod, "linearize_dense", half_dense)
    r = run()
    assert not r["correct"] and r["failed"] >= 1


def test_answer_altered_where_produced(monkeypatch):
    """One camera's translation moved by 1e-3 (the scene's radius is 5)
    in what solve returns."""
    from psba_tpu_torch.solvers import hybrid as program

    orig = program.solve

    def altered(*a, **kw):
        out = orig(*a, **kw)
        out.cams = out.cams.copy()
        out.cams[0, 3] += 1e-3
        return out

    monkeypatch.setattr(program, "solve", altered)
    r = run()
    assert not r["correct"] and r["failed"] >= 1


def test_solve_cut_one_iteration_short(monkeypatch):
    from psba_tpu_torch.solvers import hybrid as program

    orig = program.solve
    monkeypatch.setattr(program, "solve", lambda prob, cfg, **kw: orig(
        prob, cfg._replace(max_iters=cfg.max_iters - 1), **kw))
    r = run()
    assert not r["correct"]
    assert r["checks"]["iters_gap"]["value"] >= 1


def test_control_fails_program_passes():
    """The reference in float32 with TF32 products, bootstrapping its own
    lambda, in the program's place, judged as the program is."""
    spec = small_spec()
    cfg, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    drv = harness.driver(spec)
    a = ring_problem(cfg["n_cams"], cfg["n_pts"], cfg["n_obs"],
                     4_000_000_017, "cpu", cfg["assumed"])
    check = drv.Check(a, cfg, traffic, "cpu")
    control = drv.Check(a, cfg, traffic, "cpu", matmul="tf32",
                        dtype="float32")
    checks, failed = harness.judge(check, [control.as_answer()], limits)
    assert failed == 1, checks
    prog = drv.Program(a, cfg, traffic, "cpu")
    checks, failed = harness.judge(check, [prog.answer(prog.keep(
        prog.step()))], limits)
    assert failed == 0, checks


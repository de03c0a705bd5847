"""The check that decides `correct`, driven through a whole run of a small
cell on the CPU (the look for a card skipped), with the timed path broken
underneath: each fault a one-card LM cell can have makes `correct` false,
and the sound program passes. (The exchange between cards does not exist
in a one-card cell.)"""

import copy
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

# cell, cameras, points, observations (the cells' views per point where
# so few cameras see that many)
CELLS = {"dense": ("ladybug138.lm", 10, 400, 1715),
         "pairs": ("final961.lm", 16, 600, 3600)}


def run(encoding, seed=987654321987):
    name, C, P, O = CELLS[encoding]
    spec = copy.deepcopy(harness.cell(name))
    spec["config"].update(n_cams=C, n_pts=P, n_obs=O, schur=encoding)
    return harness.run_cell(name, seed, 0.2, False, time.perf_counter(),
                            device="cpu", spec=spec, log=lambda *a: None)


@pytest.mark.parametrize("encoding", ["dense", "pairs"])
def test_sound_program_is_correct(encoding):
    r = run(encoding)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == {"proj_err", "iters_gap"}


@pytest.mark.parametrize("encoding", ["dense", "pairs"])
def test_state_returned_unchanged(monkeypatch, encoding):
    from psba_tpu_torch.solvers import lm

    def unchanged(pa, state, cfg, iter_cap=None, ctx=None):
        out = copy.copy(state)
        out.itno = state.itno + iter_cap
        return out

    monkeypatch.setattr(lm, "lm_run", unchanged)
    r = run(encoding)
    assert not r["correct"] and r["failed"] >= 1
    assert r["checks"]["proj_err"]["value"] > r["checks"]["proj_err"][
        "limit"]


@pytest.mark.parametrize("encoding", ["dense", "pairs"])
def test_half_the_observations_left_out(monkeypatch, encoding):
    """The linearization sees every other point's observations only, and
    the camera sums are doubled to stand for the mean over the rest."""
    from psba_tpu_torch.solvers import lm

    if encoding == "dense":
        orig = lm.linearize_dense

        def half(K, q0, cams, pts, du, dv, valid_d, **kw):
            vd = valid_d.clone()
            vd[:, 1::2] = 0.0
            out = list(orig(K, q0, cams, pts, du, dv, vd, **kw))
            out[6], out[7] = 2 * out[6], 2 * out[7]
            return tuple(out)

        monkeypatch.setattr(lm, "linearize_dense", half)
    else:
        orig = lm.linearize_stream

        def half(K, q0, cams, pts, obs, cam_idx, pt_idx, valid, *a, **kw):
            v = (pt_idx % 2 == 0).to(obs.dtype)
            out = list(orig(K, q0, cams, pts, obs, cam_idx, pt_idx, v, *a,
                            **kw))
            out[2], out[5] = 2 * out[2], 2 * out[5]
            return tuple(out)

        monkeypatch.setattr(lm, "linearize_stream", half)
    r = run(encoding)
    assert not r["correct"] and r["failed"] >= 1


@pytest.mark.parametrize("encoding", ["dense", "pairs"])
def test_answer_altered_where_produced(monkeypatch, encoding):
    """One camera's translation moved by 1e-3 (the scene's radius is 5) in
    the state lm_run returns."""
    from psba_tpu_torch.solvers import lm

    orig = lm.lm_run

    def altered(*a, **kw):
        st = orig(*a, **kw)
        cams = st.cams.clone()
        cams[0, 3] += 1e-3
        st.cams = cams
        return st

    monkeypatch.setattr(lm, "lm_run", altered)
    r = run(encoding)
    assert not r["correct"] and r["failed"] >= 1


def test_iterations_cut_short(monkeypatch):
    from psba_tpu_torch.solvers import lm

    orig = lm.lm_run
    monkeypatch.setattr(lm, "lm_run", lambda pa, st, cfg, iter_cap=None:
                        orig(pa, st, cfg, iter_cap=iter_cap - 1))
    r = run("dense")
    assert not r["correct"]
    assert r["checks"]["iters_gap"]["value"] >= 1


def test_no_card_no_result(monkeypatch, capsys):
    """run.py without a CUDA device exits nonzero and prints no result."""
    sys.path.insert(0, str(ROOT / "portbench"))
    import run as entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = entry.main(["--workload", "ladybug138.lm", "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert "{" not in capsys.readouterr().out


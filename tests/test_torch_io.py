"""The port's own host layer against psba_tpu's: readers and problem tables.

psba_tpu_torch keeps copies of psba_tpu's problem container and numpy
readers, so the port runs without the JAX package. Both must give the same
arrays from the same input, exactly (the same numpy code and the same
random stream).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

import psba_tpu.io as jio
import psba_tpu.problem as jprob
import psba_tpu_torch.io as tio
import psba_tpu_torch.problem as tprob

MINI_BAL = str(Path(__file__).resolve().parent / "data" / "mini_bal.txt")
_FIELDS = ("K", "q0", "cams", "pts", "obs", "cam_idx", "pt_idx", "obs_cov")


def _read(pkg, name):
    if name == "synth":
        return pkg.synthetic_problem(n_cams=6, n_pts=150, seed=3)
    return pkg.bal_to_problem(MINI_BAL)


def _same(a, b):
    for f in _FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("name", ["synth", "mini_bal"])
def test_readers_match_reference(name):
    ref, got = _read(jio, name), _read(tio, name)
    assert isinstance(got, tprob.BAProblem)
    got.validate()
    _same(got, ref)
    assert (got.n_cams, got.n_pts, got.n_obs) == (ref.n_cams, ref.n_pts,
                                                  ref.n_obs)


def test_sba_text_round_trip_matches_reference(tmp_path):
    """Write mini_bal as an SBA (cams, pts) text pair and read it back with
    both packages' load_problem."""
    prob = tio.bal_to_problem(MINI_BAL)
    cams, pts = str(tmp_path / "cams.txt"), str(tmp_path / "pts.txt")
    tio.bal.write_sba_text(prob, cams, pts)
    _same(tio.load_problem(cams, pts), jio.load_problem(cams, pts))


@pytest.mark.parametrize("name", ["synth", "mini_bal"])
def test_problem_tables_match_reference(name):
    """blk_idx, the covisibility pairs and the visibility mask."""
    p = _read(tio, name)
    C, P = p.n_cams, p.n_pts
    np.testing.assert_array_equal(
        tprob.build_blk_idx(p.pt_idx, p.cam_idx, C, P),
        jprob.build_blk_idx(p.pt_idx, p.cam_idx, C, P))
    for a, b in zip(tprob.build_covis_pairs(p.pt_idx, p.cam_idx, C),
                    jprob.build_covis_pairs(p.pt_idx, p.cam_idx, C)):
        np.testing.assert_array_equal(a, b)
    jp = jprob.BAProblem(**{f: getattr(p, f) for f in _FIELDS})
    np.testing.assert_array_equal(tprob.visibility_mask(p),
                                  jprob.visibility_mask(jp))
    assert p.with_blk().blk_idx.shape == (C, P)
    assert dataclasses.replace(p.with_pairs()).pair_o1 is not None

"""The port's own host layer against psba_tpu's: readers and problem tables.

psba_tpu_torch keeps copies of psba_tpu's problem container and numpy
readers, so the port runs without the JAX package. Both must give the same
arrays from the same input, exactly (the same numpy code and the same
random stream). The port's native reader (native/loader.cpp, built into
build/psba_tpu_torch/) must give its numpy parser's arrays bit for bit.
"""

import dataclasses
import os
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


@pytest.mark.parametrize("n_cams,n_pts,mean_obs", [(40, 3000, 9.0),
                                                   (30, 9000, 5.0)])
def test_synthesize_points_matches_reference(tmp_path, n_cams, n_pts,
                                             mean_obs):
    """synthesize_points_for_cams on cameras of the synthetic ring (written
    as a 12-column camera file, look_sign +1): the port's chunked
    visibility pass gives the reference's arrays exactly, across the chunk
    boundary (9,000 points) too."""
    ring = tio.synthetic_problem(n_cams=n_cams, n_pts=50, seed=0)
    path = str(tmp_path / "cams.txt")
    tio.sba_text.write_cams(path, ring.K, ring.q0, ring.cams)
    kw = dict(n_pts=n_pts, mean_obs=mean_obs, look_sign=1.0, seed=0)
    got = tio.synthesize_points_for_cams(path, **kw)
    ref = jio.synthesize_points_for_cams(path, **kw)
    got.validate()
    _same(got, ref)


# ---------------------------------------------------------- native reader

@pytest.fixture
def sba_pair(tmp_path):
    """mini_bal written as an SBA (cams, pts) text pair."""
    cams, pts = str(tmp_path / "cams.txt"), str(tmp_path / "pts.txt")
    tio.bal.write_sba_text(tio.bal_to_problem(MINI_BAL), cams, pts)
    return cams, pts


def _same_arrays(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), i
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape, i
            np.testing.assert_array_equal(a, b, err_msg=str(i))


@pytest.mark.parametrize("kind", ["bal", "sba"])
def test_native_reader_matches_numpy_and_reference(kind, sba_pair,
                                                   monkeypatch):
    """The port's native reader (native/loader.cpp built into
    build/psba_tpu_torch/) against its numpy parser and against the
    reference's ctypes wrapper on the same library, bit for bit; the
    readers the package uses take the native one; nothing is written into
    native/."""
    from psba_tpu.io import native as jnative
    from psba_tpu_torch.io import native

    before = sorted(os.listdir(native.SOURCE.parent))
    assert native.available(), native.reader()
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert native.BUILD_DIR.parts[-2:] == ("build", "psba_tpu_torch")
    monkeypatch.setattr(jnative, "_LIB_PATH", str(lib))
    monkeypatch.setattr(jnative, "_lib", None)
    if kind == "bal":
        got = native.read_bal(MINI_BAL)
        _same_arrays(got, tio.bal.read_bal_numpy(MINI_BAL))
        _same_arrays(got, jnative.read_bal(MINI_BAL))
        _same_arrays(got, tio.bal.read_bal(MINI_BAL))
    else:
        got = native.read_pts(sba_pair[1], 20)
        _same_arrays(got, tio.sba_text.read_pts_numpy(sba_pair[1], 20))
        _same_arrays(got, jnative.read_pts(sba_pair[1], 20))
        _same_arrays(got, tio.sba_text.read_pts(sba_pair[1], 20))
    assert sorted(os.listdir(native.SOURCE.parent)) == before


def test_numpy_reader_without_gxx(sba_pair, tmp_path, monkeypatch):
    """Without g++ (and no library built) the readers fall back to numpy,
    say so, and give the same arrays."""
    from psba_tpu_torch.io import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_failed", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    assert not native.available()
    assert native.reader().startswith("numpy") and "g++" in native.reader()
    _same_arrays(tio.sba_text.read_pts(sba_pair[1], 20),
                 tio.sba_text.read_pts_numpy(sba_pair[1], 20))
    _same_arrays(tio.bal.read_bal(MINI_BAL), tio.bal.read_bal_numpy(MINI_BAL))
    assert not (tmp_path / "build").exists()

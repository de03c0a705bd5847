"""The point-run table of the observation-stream kernel's point pass (CPU).

csrc/linearize_stream.cu walks the point-sorted observations in runs of at
most RUN, cut at point boundaries, and sums V / gb per point inside a run;
a point with more than RUN observations is cut into pieces whose partial
sums the wrapper adds in order. These tests hold the table's builder to
that contract, and emulate the kernel's sums from the table against a
plain per-point sum.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from psba_tpu_torch.ops import linearize_stream as ls

RUN = ls.RUN


def _pt_idx(counts):
    return np.repeat(np.arange(len(counts)), counts)


CASES = {
    "mixed": np.random.default_rng(0).integers(0, 30, 500),
    "single_point": np.array([5]),
    "single_long_point": np.array([2 * RUN + 3]),
    "long_points_between": np.array([3, RUN + 1, 0, 2, 3 * RUN, 1, RUN]),
    "one_each": np.ones(3 * RUN + 5, np.int64),
    "unobserved_ends": np.array([0, 0, 4, RUN - 4, 1, 0, 0]),
}


def _check_runs(counts):
    counts = np.asarray(counts, np.int64)
    P = len(counts)
    pt = _pt_idx(counts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    runs, pieces, split = ls.build_point_runs(pt, P)
    # every observation exactly once, in order
    seen = np.concatenate([np.arange(o, o + c) for o, c, _, _, _ in runs])
    np.testing.assert_array_equal(seen, np.arange(len(pt)))
    whole = []
    for obs0, cnt, p0, npt, piece in runs:
        assert 0 <= cnt <= RUN and 0 <= npt <= RUN
        if piece < 0:
            # a run starts at a point boundary and holds whole points
            assert npt >= 1
            assert obs0 == starts[p0] and cnt == counts[p0:p0 + npt].sum()
            assert counts[p0:p0 + npt].max() <= RUN
            whole.extend(range(p0, p0 + npt))
        else:
            assert npt == 0 and counts[p0] > RUN
            assert (pt[obs0:obs0 + cnt] == p0).all()
    # the whole-point runs and the split points tile 0..P-1 once
    np.testing.assert_array_equal(np.sort(whole + list(split)), np.arange(P))
    assert list(split) == [p for p in range(P) if counts[p] > RUN]
    # a split point's pieces are listed in order and cover it
    for p, q in zip(split, pieces):
        rows = runs[np.isin(runs[:, 4], q)]
        np.testing.assert_array_equal(rows[:, 4], q)
        assert q == list(range(q[0], q[0] + len(q)))
        assert rows[0, 0] == starts[p] and (np.diff(rows[:, 0]) == RUN).all()
        assert rows[:, 1].sum() == counts[p]
        assert (rows[:-1, 1] == RUN).all()
    return runs, pieces, split


@pytest.mark.parametrize("case", sorted(CASES))
def test_point_runs_cover_and_cut_at_points(case):
    _check_runs(CASES[case])


def test_point_runs_edge_shapes():
    """One point: one run. A point longer than a run: pieces only. One
    observation a point: runs of RUN points each."""
    runs, pieces, split = ls.build_point_runs(_pt_idx([7]), 1)
    np.testing.assert_array_equal(runs, [[0, 7, 0, 1, -1]])
    runs, pieces, split = ls.build_point_runs(_pt_idx([2 * RUN + 3]), 1)
    np.testing.assert_array_equal(
        runs, [[0, RUN, 0, 0, 0], [RUN, RUN, 0, 0, 1], [2 * RUN, 3, 0, 0, 2]])
    assert pieces == [[0, 1, 2]] and split == [0]
    runs, _, split = ls.build_point_runs(_pt_idx(np.ones(2 * RUN + 1, int)),
                                         2 * RUN + 1)
    np.testing.assert_array_equal(runs[:, 3], [RUN, RUN, 1])
    assert split == []


def _emulated_point_sums(tables, pack):
    """The point pass's V | gb from per-observation packs [O, 12], as the
    kernel sums them (each point's observations in order inside a run, a
    piece's observations in order) and the wrapper adds the pieces."""
    runs = tables.runs.numpy()
    out = np.full((tables.n_pts, 12), np.nan, np.float32)
    pieces = np.zeros((tables.n_pieces + 1, 12), np.float32)
    pt = tables.pt32.numpy()
    for obs0, cnt, p0, npt, piece in runs:
        if piece >= 0:
            pieces[piece] = pack[obs0:obs0 + cnt].sum(0)
            continue
        for p in range(p0, p0 + npt):
            seg = pack[obs0:obs0 + cnt][pt[obs0:obs0 + cnt] == p]
            out[p] = seg.sum(0)
    if tables.n_pieces:
        out[tables.split_pt.numpy()] = pieces[
            tables.split_piece.numpy()].sum(1)
    return out


@pytest.mark.parametrize("case", ["mixed", "long_points_between"])
def test_point_runs_give_every_point_sum(case):
    counts = CASES[case]
    pt = _pt_idx(counts)
    cam = np.random.default_rng(1).integers(0, 5, len(pt))
    tables = ls.build_stream_tables(cam, pt, 5, len(counts), device="cpu")
    pack = np.random.default_rng(2).standard_normal((len(pt), 12))
    ref = np.zeros((len(counts), 12))
    np.add.at(ref, pt, pack)
    got = _emulated_point_sums(tables, pack.astype(np.float32))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_stream_tables_point_fields():
    counts = CASES["long_points_between"]
    pt = _pt_idx(counts)
    cam = np.arange(len(pt)) % 3
    st = ls.build_stream_tables(cam, pt, 3, len(counts) + 2, device="cpu")
    assert st.n_pts == len(counts) + 2
    assert st.cam32.dtype == st.pt32.dtype == st.runs.dtype == torch.int32
    np.testing.assert_array_equal(st.cam32.numpy(), cam)
    np.testing.assert_array_equal(st.pt32.numpy(), pt)
    # points 1 (RUN + 1) and 4 (3 RUN) are cut: 2 and 3 pieces, the first
    # padded with the zero row n_pieces
    np.testing.assert_array_equal(st.split_pt.numpy(), [1, 4])
    assert st.n_pieces == 5
    np.testing.assert_array_equal(st.split_piece.numpy(),
                                  [[0, 1, 5], [2, 3, 4]])
    # the two trailing points without observations belong to the last run
    last = st.runs.numpy()[-1]
    assert last[2] + last[3] == len(counts) + 2


def test_point_runs_need_point_order():
    pt = np.array([0, 2, 1, 1])
    with pytest.raises(ValueError, match="sorted by point"):
        ls.build_point_runs(pt, 3)
    st = ls.build_stream_tables(np.zeros(4, int), pt, 1, 3, device="cpu")
    assert st.runs.shape == (0, 5)


def test_problem_arrays_share_index_copies():
    from psba_tpu_torch.io import bal_to_problem
    from psba_tpu_torch.solvers import ProblemArrays

    prob_mini_bal = bal_to_problem(
        str(Path(__file__).parent / "data" / "mini_bal.txt"))
    pa = ProblemArrays.from_problem(prob_mini_bal, dtype=torch.float32,
                                    schur="pairs", device="cpu")
    assert pa.cam_idx32 is pa.stream.cam32 and pa.pt_idx32 is pa.stream.pt32
    assert pa.stream.n_pts == prob_mini_bal.n_pts
    _check_runs(np.bincount(prob_mini_bal.pt_idx,
                            minlength=prob_mini_bal.n_pts))

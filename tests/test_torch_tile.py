"""Port against reference: the dense path's tile point order and the exact
(camera, tile) occupancy skip, on CPU tensors.

The port's counterparts of tests/test_pallas.py::test_tile_mask_skip_exact
and ::test_tile_point_order_roundtrip. The port's dense kernels cover 128
consecutive points by 8 cameras, where the TPU kernels cover strided
[8, 256] lane windows, so the two packages assign the clustered points to
different slots; the ranks (the order in which the tiles take the points)
are the same. Problems: the 6-camera synthetic, tests/data/mini_bal.txt and
a sparse ring (20 cameras of the synthetic ring, 3,000 points at about four
views each, in the way chip_smoke.py builds ladybug138_real), each read or
built once and handed to both packages as the same arrays.

Tolerances: the clustered problem's initial L2 to 1e-12 (float64, sums in
another order); the plain versions with the true mask bit for bit (the
mask multiplies the validity table by exactly 1); float32 solves against
the reference's to 1e-3 in final L2 with equal phases (sums in another
order), float64 ones as tests/test_torch_f64.py holds them.
"""

import os
import tempfile
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psba_tpu.solvers import SolverConfig as JSolverConfig
from psba_tpu.solvers.hybrid import solve as jsolve
from psba_tpu_torch.ops import linearize_dense as ld
from psba_tpu_torch.ops import residual_dense as rd
from psba_tpu_torch.solvers import ProblemArrays, SolverConfig
from psba_tpu_torch.solvers.hybrid import solve
from psba_tpu_torch.utils import checkpoint as ckpt

MINI_BAL = str(Path(__file__).resolve().parent / "data" / "mini_bal.txt")
F32, F64 = torch.float32, torch.float64
NAMES = ["synth", "mini_bal", "ring"]


def _ring():
    """The sparse ring: 20 cameras of the synthetic_problem ring, points
    from synthesize_points_for_cams (look_sign +1, seed 0), capped at four
    views each."""
    from psba_tpu_torch.io import synthesize_points_for_cams, synthetic_problem
    from psba_tpu_torch.io.sba_text import write_cams

    ring = synthetic_problem(n_cams=20, n_pts=50, seed=0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cams.txt")
        write_cams(path, ring.K, ring.q0, ring.cams)
        return synthesize_points_for_cams(path, n_pts=3000, mean_obs=4.3,
                                          look_sign=1.0, seed=0)


_CACHE = {}


def _problems(name):
    """(psba_tpu problem, psba_tpu_torch problem) with the same arrays."""
    if name not in _CACHE:
        import psba_tpu.io as jio
        from psba_tpu.problem import BAProblem as JBAProblem
        import psba_tpu_torch.io as tio

        if name == "synth":
            _CACHE[name] = (jio.synthetic_problem(n_cams=6, n_pts=150,
                                                  seed=3),
                            tio.synthetic_problem(n_cams=6, n_pts=150,
                                                  seed=3))
        elif name == "mini_bal":
            _CACHE[name] = (jio.bal_to_problem(MINI_BAL),
                            tio.bal_to_problem(MINI_BAL))
        else:
            t = _ring()
            j = JBAProblem(K=t.K, q0=t.q0, cams=t.cams, pts=t.pts, obs=t.obs,
                           cam_idx=t.cam_idx, pt_idx=t.pt_idx)
            _CACHE[name] = (j, t)
    return _CACHE[name]


def _crc(newpos):
    return f"tile-{zlib.crc32(np.ascontiguousarray(newpos)):08x}"


def _occupancy(prob):
    """Brute-force [C, n_tiles] count of each camera's observations per
    128-point tile, from the observation list."""
    n_tiles = -(-prob.n_pts // 128)
    cnt = np.zeros((prob.n_cams, n_tiles), np.int64)
    np.add.at(cnt, (prob.cam_idx, prob.pt_idx // 128), 1)
    return cnt


@pytest.mark.parametrize("name", NAMES)
def test_point_ranks_match_reference(name):
    """newpos is a bijection, and each point's rank in the port's tile
    order is its rank in the reference's visit order:
    newpos == inv(ref tile_slot_order)[ref newpos]."""
    from psba_tpu.ops.linearize_dense import tile_slot_order as ref_slots

    jprob, tprob = _problems(name)
    P = tprob.n_pts
    t2, newpos = tprob.with_tile_point_order()
    _j2, ref_newpos = jprob.with_tile_point_order()
    t2.validate()
    np.testing.assert_array_equal(np.sort(newpos), np.arange(P))
    np.testing.assert_array_equal(ld.tile_slot_order(P), np.arange(P))
    slots = ref_slots(P)
    rank = np.empty(P, np.int64)
    rank[slots] = np.arange(P)
    np.testing.assert_array_equal(newpos, rank[np.asarray(ref_newpos)])
    np.testing.assert_array_equal(t2.pts[newpos], tprob.pts)
    assert t2.blk_idx is None and t2.pair_o1 is None


@pytest.mark.parametrize("name", NAMES)
def test_clustered_problem_same_initial_l2(name):
    """The clustered problem is the same problem: its observations, in the
    new point order, give the initial L2 of the original (float64)."""
    from psba_tpu_torch.solvers.types import OptState

    _jprob, tprob = _problems(name)
    t2, _newpos = tprob.with_tile_point_order()
    l2 = []
    for p in (tprob, t2):
        pa = ProblemArrays.from_problem(p, dtype=F64, device="cpu")
        st = OptState.init(pa, torch.as_tensor(p.cams, dtype=F64),
                           torch.as_tensor(p.pts, dtype=F64))
        l2.append(float(st.ex_l2))
    np.testing.assert_allclose(l2[1], l2[0], rtol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_build_tile_mask_is_the_occupancy(name):
    """build_tile_mask (what from_problem builds for the kernel path)
    equals a brute-force count per (camera, 128-point tile) in both point
    orders; clustering never raises the occupied share and, on the sparse
    ring, lowers it."""
    _jprob, tprob = _problems(name)
    t2, _newpos = tprob.with_tile_point_order()
    share = []
    for p in (tprob, t2):
        pa = ProblemArrays.from_problem(p, dtype=F32, schur="dense",
                                        device="cpu")
        want = (_occupancy(p) > 0).astype(np.int32)
        assert pa.tile_mask.dtype == torch.int32
        assert pa.tile_mask.shape == (p.n_cams, ld.padded_points(p.n_pts)
                                      // ld.PTILE)
        np.testing.assert_array_equal(pa.tile_mask.numpy(), want)
        np.testing.assert_array_equal(
            ld.build_tile_mask(pa.valid_d).numpy(), want)
        share.append(float(want.mean()))
    print(f"{name}: occupied (camera, tile) share natural {share[0]:.3f}, "
          f"clustered {share[1]:.3f}")
    assert share[1] <= share[0]
    if name == "ring":
        assert share[1] < 0.8 * share[0]
    # the XLA form gets no grid tables and no occupancy table
    pa64 = ProblemArrays.from_problem(t2, dtype=F64, schur="dense",
                                      device="cpu")
    assert pa64.tile_mask is None and pa64.valid_d is None


def _dense_args(prob, seed=0):
    """Float32 dense arguments of the clustered `prob` at cameras and
    points perturbed from a seed, its tile mask, and a second state."""
    p2, _ = prob.with_tile_point_order()
    pa = ProblemArrays.from_problem(p2, dtype=F32, schur="dense", device="cpu")
    rng = np.random.default_rng(seed)
    C = p2.n_cams
    f = lambda a: torch.as_tensor(a, dtype=F32)
    cams = f(p2.cams + np.concatenate(
        [1e-3 * rng.standard_normal((C, 3)),
         1e-2 * rng.standard_normal((C, 3))], axis=1))
    pts = f(p2.pts)
    new = (cams + f(1e-4 * rng.standard_normal(cams.shape)),
           pts + f(1e-3 * rng.standard_normal(pts.shape)))
    return p2, pa, cams, pts, new


def _plain_outputs(pa, cams, pts, new, valid_d, tile_mask):
    lin = ld.linearize_dense_plain(pa.K, pa.q0, cams, pts, pa.obs_du,
                                   pa.obs_dv, valid_d, want_u=True,
                                   tile_mask=tile_mask)
    gain = rd.gain_dense_plain(pa.K, pa.q0, cams, pts, *new, pa.obs_du,
                               pa.obs_dv, valid_d, tile_mask=tile_mask)
    rng = np.random.default_rng(7)
    C, P = valid_d.shape
    dc = torch.as_tensor(rng.standard_normal((2, C, 6)), dtype=F32)
    dp = torch.as_tensor(rng.standard_normal((2, 3, P)), dtype=F32)
    G = rd.jgram_dense_plain(pa.K, pa.q0, cams, pts, valid_d, dc, dp,
                             tile_mask=tile_mask)
    return [t for t in lin if isinstance(t, torch.Tensor)] + [*gain, G]


@pytest.mark.parametrize("name", NAMES)
def test_plain_versions_apply_the_mask_exactly(name):
    """The three plain versions with the true mask give the bits they give
    without it; with an observed tile's bit cleared they give the bits of
    the plain version on valid_d with that tile's cells zeroed, which
    differ from the unmasked ones."""
    _jprob, tprob = _problems(name)
    p2, pa, cams, pts, new = _dense_args(tprob)
    free = _plain_outputs(pa, cams, pts, new, pa.valid_d, None)
    masked = _plain_outputs(pa, cams, pts, new, pa.valid_d, pa.tile_mask)
    for a, b in zip(masked, free):
        assert torch.equal(a, b)
    # clear the bit of camera 1's first observed tile
    c = 1
    t = int(torch.nonzero(pa.tile_mask[c])[0])
    cut = pa.tile_mask.clone()
    cut[c, t] = 0
    vd = pa.valid_d.clone()
    vd[c, t * ld.PTILE:(t + 1) * ld.PTILE] = 0.0
    assert int((pa.valid_d != vd).sum()) > 0
    got = _plain_outputs(pa, cams, pts, new, pa.valid_d, cut)
    want = _plain_outputs(pa, cams, pts, new, vd, None)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[-1], free[-1])   # the J-gram moved


def _port_cfg(dtype, **kw):
    return SolverConfig.for_dtype(dtype, record_history=True, **kw)


@pytest.mark.parametrize("name", NAMES)
def test_dense_f32_solve_clusters_and_matches_reference(name):
    """solve(device="cpu") on the dense encoding, float32, LM for six
    iterations (short of the DP_NO_CHANGE stop, which float32 rounding
    decides): the reference's clustered solve (Pallas in interpret mode)
    gives the same phases and its final L2 to 1e-3; the parameters come
    back in the caller's order (a zero-iteration solve returns the input
    points as they are)."""
    jprob, tprob = _problems(name)
    kw = dict(max_iters=6, lm_switch_count=10_000)
    ref = jsolve(jprob, JSolverConfig.for_dtype(jnp.float32, backend="pallas",
                                                record_history=True, **kw),
                 dtype=jnp.float32, schur="dense")
    res = solve(tprob, _port_cfg(F32, **kw), dtype=F32, device="cpu",
                schur="dense")
    assert res.phases == ref.phases
    np.testing.assert_allclose(res.final_l2, ref.final_l2, rtol=1e-3)
    assert res.final_l2 < res.initial_l2
    assert res.pts.shape == tprob.pts.shape
    scale = np.max(np.abs(ref.pts))
    assert np.max(np.abs(res.pts - ref.pts)) <= 1e-3 * scale
    zero = solve(tprob, _port_cfg(F32, max_iters=0), dtype=F32,
                 device="cpu", schur="dense")
    np.testing.assert_array_equal(zero.pts, tprob.pts.astype(np.float32))


@pytest.mark.parametrize("name", NAMES)
def test_dense_f64_solve_clusters_and_matches_reference(name):
    """The default float64 solve (the XLA form, clustered in both
    packages) against the reference's, as tests/test_torch_f64.py holds
    it: phases through the first TR phase, LM rows before it to 1e-9,
    final L2 to 1e-6, initial L2 to 1e-12 (the parameters are not held:
    the gauge lets them drift where the L2 does not move); a
    zero-iteration solve returns the caller's points as they are."""
    jprob, tprob = _problems(name)
    ref = jsolve(jprob, JSolverConfig.for_dtype(jnp.float64,
                                                record_history=True))
    res = solve(tprob, _port_cfg(F64), device="cpu")
    names = [ph for ph, _, _ in ref.phases]
    k = names.index("tr") if "tr" in names else len(names) - 1
    assert res.phases[:k + 1] == ref.phases[:k + 1]
    lm_end = ref.phases[k - 1][1] if k > 0 else ref.phases[0][1]
    np.testing.assert_allclose(res.history[:lm_end, 1:4],
                               ref.history[:lm_end, 1:4], rtol=1e-9)
    np.testing.assert_allclose(res.final_l2, ref.final_l2, rtol=1e-6)
    np.testing.assert_allclose(res.initial_l2, ref.initial_l2, rtol=1e-12)
    zero = solve(tprob, _port_cfg(F64, max_iters=0), device="cpu")
    np.testing.assert_array_equal(zero.pts, tprob.pts)


def test_loops_pass_the_mask_on_every_dense_call(monkeypatch):
    """The LM and TR loops hand ProblemArrays.tile_mask to every call of
    the three dense kernels (the default config, which runs both)."""
    from psba_tpu_torch.solvers import lm as lm_mod
    from psba_tpu_torch.solvers import tr as tr_mod

    seen = []

    def spy(mod, name):
        real = getattr(mod, name)

        def call(*a, tile_mask=None, **kw):
            seen.append((name, tile_mask))
            return real(*a, tile_mask=tile_mask, **kw)

        monkeypatch.setattr(mod, name, call)

    for mod, names in ((lm_mod, ("linearize_dense", "gain_dense")),
                       (tr_mod, ("linearize_dense", "gain_dense",
                                 "jgram_dense"))):
        for n in names:
            spy(mod, n)
    _jprob, tprob = _problems("ring")
    res = solve(tprob, _port_cfg(F32, max_iters=12), dtype=F32, device="cpu")
    assert "tr" in [ph for ph, _, _ in res.phases]
    assert {n for n, _ in seen} == {"linearize_dense", "gain_dense",
                                    "jgram_dense"}
    p2, _ = tprob.with_tile_point_order()
    want = (_occupancy(p2) > 0).astype(np.int32)
    for _n, m in seen:
        assert m is not None
        np.testing.assert_array_equal(m.numpy(), want)


def test_chunked_run_resumes_in_tile_order(tmp_path):
    """A chunked dense run writes tile-<crc> checkpoints and follows the
    unchunked run; a resume from a mid-run checkpoint continues in that
    order and ends where the unchunked run ends."""
    _jprob, tprob = _problems("mini_bal")
    _p2, newpos = tprob.with_tile_point_order()
    cfg = _port_cfg(F32, max_iters=12, lm_switch_count=10_000)
    whole = solve(tprob, cfg, dtype=F32, device="cpu")
    d = tmp_path / "ck"
    chunked = solve(tprob, cfg, dtype=F32, device="cpu",
                    checkpoint_dir=str(d), checkpoint_every=4)
    np.testing.assert_array_equal(chunked.history, whole.history)
    np.testing.assert_array_equal(chunked.pts, whole.pts)
    _cams, pts, meta = ckpt.load_latest(str(d))
    assert meta["point_order"] == _crc(newpos)
    # checkpoints hold the points in the solver's (clustered) order
    np.testing.assert_array_equal(pts[newpos], whole.pts)
    (d / "latest").write_text("ckpt_00008.npz")
    resumed = solve(tprob, cfg, dtype=F32, device="cpu",
                    checkpoint_dir=str(d), checkpoint_every=4)
    assert resumed.iterations == whole.iterations
    np.testing.assert_allclose(resumed.final_l2, whole.final_l2, rtol=1e-5)
    scale = np.max(np.abs(whole.pts))
    assert np.max(np.abs(resumed.pts - whole.pts)) <= 1e-5 * scale


def test_pairs_checkpoint_refused_by_dense_run(tmp_path):
    """A checkpoint of a pair run (points in the caller's order) is refused
    by a dense run, whose points are clustered, and the other way round."""
    _jprob, tprob = _problems("synth")
    cfg = _port_cfg(F32, max_iters=3, lm_switch_count=10_000)
    kw = dict(dtype=F32, device="cpu", checkpoint_every=0)
    solve(tprob, cfg, schur="pairs", checkpoint_dir=str(tmp_path / "p"),
          **kw)
    assert ckpt.load_latest(str(tmp_path / "p"))[2]["point_order"] == (
        "natural")
    with pytest.raises(ValueError, match="order"):
        solve(tprob, cfg, schur="dense", checkpoint_dir=str(tmp_path / "p"),
              **kw)
    solve(tprob, cfg, schur="dense", checkpoint_dir=str(tmp_path / "d"),
          **kw)
    with pytest.raises(ValueError, match="order"):
        solve(tprob, cfg, schur="pairs", checkpoint_dir=str(tmp_path / "d"),
              **kw)

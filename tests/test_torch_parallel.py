"""Port against reference: the sharded solve (psba_tpu_torch.parallel), on
the CPU.

shard_problem against the reference's, array for array; MeshCtx's
reductions over two gloo ranks against numpy; solve_sharded in two gloo
processes against psba_tpu.parallel.shard.solve_sharded on the conftest's
virtual CPU mesh (float64: the XLA form on both sides; float32: the port's
kernel path in plain PyTorch against the reference's XLA form); one rank
against lm_run bit for bit; a shard padded by hand (valid = False on the
padding, zero points without observations) against the same shard
unpadded. Each test that starts processes passes run_ranks a timeout of at
most 120 s, so a hung rank fails the test. Tolerances are stated beside
each test.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests import _torch_mesh_worker as worker

# the spawning tests' own limit on their ranks, seconds
RANKS_TIMEOUT = 120
MINI_BAL = str(Path(__file__).resolve().parent / "data" / "mini_bal.txt")


def _problems(name="synth"):
    """(psba_tpu problem, psba_tpu_torch problem), each read or made by its
    own package: "synth" (6 cameras, from a seed) or "mini" (mini_bal, 20
    cameras; two shards pad 11 observations and 2 points)."""
    import psba_tpu.io as jio
    import psba_tpu_torch.io as tio

    if name == "mini":
        return jio.bal_to_problem(MINI_BAL), tio.bal_to_problem(MINI_BAL)
    return (jio.synthetic_problem(n_cams=6, n_pts=150, seed=3),
            tio.synthetic_problem(n_cams=6, n_pts=150, seed=3))


# ------------------------------------------------------------ shard_problem

@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_shard_problem_matches_reference(n, schur):
    """Every field of the port's ShardedProblem equals the reference's, in
    value and dtype, on mini_bal, whose shards are padded."""
    from psba_tpu.parallel.shard import shard_problem as j_shard
    from psba_tpu_torch.parallel.shard import shard_problem as t_shard

    jp, tp = _problems("mini")
    ref, got = j_shard(jp, n, schur=schur), t_shard(tp, n, schur=schur)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if b is None or isinstance(b, int):
            assert a == b, f.name
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert not got.valid.all() and not got.pt_valid.all()


def test_slice_local():
    """The point ranges tile the points; slice_local of every rank, stacked
    again, gives back the sharded arrays, and each shard's real points are
    the caller's points of its range."""
    from psba_tpu_torch.parallel.distributed import slice_local
    from psba_tpu_torch.parallel.shard import shard_problem

    _, tp = _problems()
    sp = shard_problem(tp, 3, schur="pairs")
    starts = sp.pt_starts
    assert starts[0] == 0 and starts[-1] == tp.n_pts
    assert np.all(np.diff(starts) > 0)
    parts = [slice_local(sp, r) for r in range(3)]
    np.testing.assert_array_equal(
        np.concatenate([p.obs for p in parts]), sp.obs)
    np.testing.assert_array_equal(
        np.concatenate([p.pair_bucket for p in parts]), sp.pair_bucket)
    for r, p in enumerate(parts):
        n_real = int(p.pt_starts[1])
        np.testing.assert_array_equal(p.pts[:n_real],
                                      tp.pts[starts[r]:starts[r + 1]])


def test_resolve_damping_host_matches_reference():
    """The host damping probe resolves as the reference's does, in both
    dtypes and with the Marquardt range forced by a tiny tau's opposite (a
    huge one)."""
    from psba_tpu.parallel.shard import _resolve_damping_host
    from psba_tpu.solvers import SolverConfig as JConfig
    from psba_tpu_torch.parallel.shard import resolve_damping_host
    from psba_tpu_torch.solvers import SolverConfig

    jp, tp = _problems()
    for dt, tau in ((np.float64, 1e-3), (np.float32, 1e-3),
                    (np.float32, 1e12)):
        ref = _resolve_damping_host(JConfig(tau=tau), jp, dt)
        got = resolve_damping_host(SolverConfig(tau=tau), tp,
                                   torch.float32 if dt == np.float32
                                   else torch.float64, "cpu")
        assert (got.damping, got.lm_switch_count) == (
            ref.damping, ref.lm_switch_count), (dt, tau)


# ------------------------------------------------------------------ MeshCtx

def test_mesh_ctx_reductions_two_gloo_ranks():
    """psum (one tensor and two in one collective), pmax, pand and psum_rs
    (7 entries over 2 ranks: padded and cut back) over two gloo ranks,
    against numpy on the ranks' inputs. float64, sums of two terms: exact.
    Both ranks get the same results; the counters record one collective a
    call."""
    from psba_tpu_torch.parallel.distributed import run_ranks

    out = run_ranks(["cpu", "cpu"], "gloo", worker.mesh_reductions,
                    timeout=RANKS_TIMEOUT, seed=5)
    a = out[0]["a"] + out[1]["a"]
    b = out[0]["b"] + out[1]["b"]
    for r in out:
        np.testing.assert_array_equal(r["psum"], a)
        np.testing.assert_array_equal(r["psum_many"][0], a)
        np.testing.assert_array_equal(r["psum_many"][1], b)
        np.testing.assert_array_equal(
            r["pmax"], np.maximum(out[0]["b"], out[1]["b"]))
        assert r["pand_all"] is True and r["pand_one"] is False
        assert r["psum_rs"].shape == (7,)
        np.testing.assert_array_equal(r["psum_rs"], b)
        assert r["stats"]["many"]["calls"] == 1
        assert r["stats"]["many"]["bytes"] == 8 * (12 + 7)
        assert r["stats"]["pand"]["calls"] == 2


def test_mesh_ctx_without_group_is_identity():
    """NO_MESH returns its inputs and counts nothing."""
    from psba_tpu_torch.parallel.ctx import NO_MESH

    x, y = torch.arange(5.0), torch.ones(2)
    assert NO_MESH.psum(x) is x and NO_MESH.psum_rs(x) is x
    assert NO_MESH.pmax(x) is x
    assert NO_MESH.psum(x, y) == (x, y)
    ok = torch.tensor(False)
    assert NO_MESH.pand(ok) is ok
    assert NO_MESH.summary() == {}


def test_run_ranks_raises_when_a_rank_fails():
    """A rank that raises makes run_ranks raise with its traceback, and the
    rank left waiting in a collective is stopped."""
    from psba_tpu_torch.parallel.distributed import run_ranks

    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(["cpu", "cpu"], "gloo", worker.fail_on_rank_one,
                  timeout=RANKS_TIMEOUT)


def test_run_ranks_timeout():
    """Ranks running past the timeout are stopped and run_ranks raises."""
    from psba_tpu_torch.parallel.distributed import run_ranks

    with pytest.raises(TimeoutError):
        run_ranks(["cpu", "cpu"], "gloo", worker.sleep_long, timeout=15)


def test_solve_sharded_on_cuda_without_a_card_raises():
    """No card, no quiet fall-back to the CPU."""
    from psba_tpu_torch.parallel.shard import solve_sharded

    _, tp = _problems()
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="devices requested"):
            solve_sharded(tp, n_devices=torch.cuda.device_count() + 1)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solve_sharded(tp, n_devices=2)


# ---------------------------------------------------- the sharded solve

def _l2_at(prob, cams, pts):
    """sum |ex|^2 of the whole problem at (cams, pts), in float64."""
    from psba_tpu_torch.core.residual import error_l2, residuals

    f = lambda a: torch.as_tensor(np.asarray(a, np.float64))
    i = lambda a: torch.as_tensor(np.asarray(a, np.int64))
    return float(error_l2(residuals(f(prob.K), f(prob.q0), f(cams), f(pts),
                                    f(prob.obs), i(prob.cam_idx),
                                    i(prob.pt_idx))))


@pytest.mark.parametrize("dt,schur,s_reduce", [
    (np.float64, "dense", "psum"),
    (np.float64, "pairs", "scatter"),
    (np.float32, "dense", "psum"),
    (np.float32, "pairs", "scatter"),
])
def test_solve_sharded_matches_reference(dt, schur, s_reduce):
    """solve_sharded(n_devices=2, device="cpu") (two gloo processes)
    against the reference's solve_sharded(n_devices=2) on the virtual CPU
    mesh, the default hybrid solve of mini_bal (11 padded observations, 2
    padded points). float64 (the XLA form on both sides):
    the same phases and iterations, final error to 1e-9 relative
    (tests/test_distributed.py's gate). float32 (the port's kernel path in
    plain PyTorch, the reference's XLA form): the same first LM phase and
    the switch to TR (TR's GMW bootstrap reads rounding noise), final L2 to
    1e-3 relative. The points (of two ranks, gathered) and cameras
    returned reproject to the final L2: to 1e-9 in float64, 1e-3 in float32
    (the solver tracks L2 by its gains). The optimum is not unique (the
    gauge), so points are not compared with the reference's."""
    from psba_tpu.parallel.shard import solve_sharded as j_solve
    from psba_tpu.solvers import SolverConfig as JConfig
    from psba_tpu_torch.parallel.shard import solve_sharded
    from psba_tpu_torch.solvers import SolverConfig

    assert len(jax.devices()) >= 2
    jp, tp = _problems("mini")
    ref = j_solve(jp, JConfig.for_dtype(dt, s_reduce=s_reduce), n_devices=2,
                  dtype=dt if dt == np.float32 else None, schur=schur)
    got = solve_sharded(tp, SolverConfig.for_dtype(dt, s_reduce=s_reduce),
                        n_devices=2, dtype=dt, schur=schur, device="cpu",
                        timeout=RANKS_TIMEOUT)
    assert got.resolved_damping == ref.resolved_damping
    assert got.pts.shape == tp.pts.shape
    assert got.collectives["S"]["calls"] > 0
    np.testing.assert_allclose(_l2_at(tp, got.cams, got.pts), got.final_l2,
                               rtol=1e-9 if dt == np.float64 else 1e-3)
    if dt == np.float64:
        assert got.phases == [tuple(p) for p in ref.phases]
        assert got.iterations == ref.iterations
        np.testing.assert_allclose(got.final_error, ref.final_error,
                                   rtol=1e-9)
    else:
        assert got.phases[0] == tuple(ref.phases[0])
        assert got.phases[1][0] == ref.phases[1][0] == "tr"
        np.testing.assert_allclose(got.final_l2, ref.final_l2, rtol=1e-3)


def _lm_cfg(dt, damping="additive", iters=6):
    from psba_tpu_torch.solvers import SolverConfig

    return SolverConfig.for_dtype(dt, max_iters=iters,
                                  lm_switch_count=10_000, damping=damping)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_one_rank_same_bits_as_lm_run(dt, schur):
    """solve_sharded(n_devices=1): one gloo rank in the calling process, so
    every reduction passes its input through. Its LM run gives the bits of
    OptState.init + lm_run on ProblemArrays.from_problem in the caller's
    point order: cameras, points and final L2."""
    from psba_tpu_torch.parallel.shard import solve_sharded
    from psba_tpu_torch.solvers import OptState, ProblemArrays
    from psba_tpu_torch.solvers.lm import lm_run

    _, tp = _problems()
    cfg = _lm_cfg(dt)
    got = solve_sharded(tp, cfg, n_devices=1, dtype=dt, schur=schur,
                        device="cpu")
    pa = ProblemArrays.from_problem(tp, dtype=dt, schur=schur, device="cpu")
    t = lambda a: torch.as_tensor(a, dtype=dt)
    st = lm_run(pa, OptState.init(pa, t(tp.cams), t(tp.pts)), cfg)
    assert got.phases == [("lm", st.itno, st.flag)]
    np.testing.assert_array_equal(got.cams, st.cams.numpy())
    np.testing.assert_array_equal(got.pts, st.pts.numpy())
    assert got.final_l2 == float(st.ex_l2)
    assert got.collectives["lm_try"]["calls"] >= st.itno


# ------------------------------------------------------- the padding mask

def _pad_by_hand(sp, k_o, k_p):
    """A one-shard ShardedProblem with k_o padded observations (repeating
    the first, valid False, out of the pair list and the dense table) and
    k_p zero points without observations appended."""
    C = sp.K.shape[0]
    o_per, p_per = sp.o_per + k_o, sp.p_per + k_p
    rep = lambda a: np.concatenate([a, np.repeat(a[:1], k_o, 0)])
    cols = lambda a, fill: None if a is None else np.concatenate(
        [a, np.full((C, k_p), fill, a.dtype)], axis=1)
    fields = dict(
        o_per=o_per, p_per=p_per, obs=rep(sp.obs), cam_idx=rep(sp.cam_idx),
        pt_idx=rep(sp.pt_idx),
        valid=np.concatenate([sp.valid, np.zeros(k_o, bool)]),
        pts=np.concatenate([sp.pts, np.zeros((k_p, 3), sp.pts.dtype)]),
        pt_valid=np.concatenate([sp.pt_valid, np.zeros(k_p, bool)]),
        obs_du=cols(sp.obs_du, 0), obs_dv=cols(sp.obs_dv, 0),
        valid_d=cols(sp.valid_d, 0))
    if sp.blk is not None:
        fields["blk"] = cols(np.where(sp.blk < sp.o_per, sp.blk, o_per),
                             o_per)
    else:
        z = np.zeros(k_o, np.int32)
        fields.update(
            n_per=sp.n_per + k_o,
            pair_o1=np.concatenate([sp.pair_o1, z]),
            pair_o2=np.concatenate([sp.pair_o2, z]),
            pair_bucket=np.concatenate([sp.pair_bucket, z + C * C]))
    return dataclasses.replace(sp, **fields)


def _shards(schur, dt=torch.float32, k_o=5, k_p=3):
    """(unpadded ProblemArrays, padded ProblemArrays, problem) of the
    synthetic problem as one shard."""
    from psba_tpu_torch.parallel.distributed import slice_local
    from psba_tpu_torch.parallel.shard import local_arrays, shard_problem

    _, tp = _problems()
    sp = slice_local(shard_problem(tp, 1, schur=schur), 0)
    pa = local_arrays(sp, dt, "cpu")
    pad = local_arrays(_pad_by_hand(sp, k_o, k_p), dt, "cpu")
    assert pa.valid is None and int((~pad.valid).sum()) == k_o
    return pa, pad, tp


def test_padded_residual_l2_matches_unpadded():
    """residual_l2 (kernel 6's plain version) with valid and ex_old on the
    padded shard: the real rows' residuals bit for bit, l2 and the gain to
    1e-6 relative (float32 sums in another order)."""
    from psba_tpu_torch.ops.linearize_stream import residual_l2

    pa, pad, tp = _shards("pairs")
    rng = np.random.default_rng(4)
    cams = torch.as_tensor(tp.cams + 1e-3 * rng.standard_normal(
        tp.cams.shape), dtype=torch.float32)
    pts = torch.as_tensor(tp.pts, dtype=torch.float32)
    pts_pad = torch.cat([pts, torch.zeros(3, 3)])
    old = residual_l2(pa.K, pa.q0, cams * 0.999, pts, pa.obs, pa.cam_idx32,
                      pa.pt_idx32)[0]
    old_pad = residual_l2(pad.K, pad.q0, cams * 0.999, pts_pad, pad.obs,
                          pad.cam_idx32, pad.pt_idx32)[0]
    ex, l2, gain = residual_l2(pa.K, pa.q0, cams, pts, pa.obs, pa.cam_idx32,
                               pa.pt_idx32, None, ex_old=old)
    ex_p, l2_p, gain_p = residual_l2(pad.K, pad.q0, cams, pts_pad, pad.obs,
                                     pad.cam_idx32, pad.pt_idx32,
                                     pad.valid_f, ex_old=old_pad)
    np.testing.assert_array_equal(ex_p[pad.valid].numpy(), ex.numpy())
    np.testing.assert_allclose(float(l2_p), float(l2), rtol=1e-6)
    np.testing.assert_allclose(float(gain_p), float(gain), rtol=1e-6)


def test_padded_linearize_stream_matches_unpadded():
    """linearize_stream (kernel 5's plain version) with the pair flags and
    the Jacobians on the padded shard: U, ga, l2, V, gb to 1e-6 relative
    (float32 sums in another order); the real rows' W, A and B bit for bit;
    the padding's W, A, B and the padded points' V, gb zero."""
    from psba_tpu_torch.ops.linearize_stream import linearize_stream

    pa, pad, tp = _shards("pairs")
    cams = torch.as_tensor(tp.cams, dtype=torch.float32)
    pts = torch.as_tensor(tp.pts, dtype=torch.float32)
    pts_pad = torch.cat([pts, torch.zeros(3, 3)])
    C, P = tp.n_cams, tp.n_pts
    ref = linearize_stream(pa.K, pa.q0, cams, pts, pa.obs, pa.cam_idx,
                           pa.pt_idx, None, C, P, want_jac=True)
    got = linearize_stream(pad.K, pad.q0, cams, pts_pad, pad.obs,
                           pad.cam_idx, pad.pt_idx, pad.valid_f, C, P + 3,
                           want_jac=True)
    ex, l2, U, V, W, ga, gb, A, B = got
    for name, a, b in (("l2", l2, ref[1]), ("U", U, ref[2]),
                       ("V", V[:P], ref[3]), ("ga", ga, ref[5]),
                       ("gb", gb[:P], ref[6])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(b.abs().max()),
                                   err_msg=name)
    for name, a, b in (("W", W, ref[4]), ("A", A, ref[7]), ("B", B, ref[8])):
        np.testing.assert_array_equal(a[pad.valid].numpy(), b.numpy(),
                                      err_msg=name)
        assert float(a[~pad.valid].abs().max()) == 0.0, name
    assert float(V[P:].abs().max()) == 0.0 and float(gb[P:].abs().max()) == 0


@pytest.mark.parametrize("damping", ["additive", "marquardt"])
@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_padded_lm_run_matches_unpadded(damping, schur):
    """Eight LM iterations (the float32 kernel path in plain PyTorch) on
    the padded shard against the unpadded one, under each damping: the
    same iterations and flag, final L2 to 1e-5 and the cameras to 1e-4
    relative (float32 sums in another order); the padded points have zero
    V blocks (damped to mu I under both modes) and stay at zero. The
    damping probe gives the same mode with the mask."""
    from psba_tpu_torch.solvers import OptState, resolve_damping
    from psba_tpu_torch.solvers.lm import lm_run

    pa, pad, tp = _shards(schur)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32)
    cams, pts = t(tp.cams), t(tp.pts)
    pts_pad = torch.cat([pts, torch.zeros(3, 3)])
    cfg = _lm_cfg(torch.float32, damping=damping, iters=8)
    auto = cfg._replace(damping="auto")
    assert (resolve_damping(auto, pa, cams, pts).damping
            == resolve_damping(auto, pad, cams, pts_pad).damping)
    ref = lm_run(pa, OptState.init(pa, cams, pts), cfg)
    got = lm_run(pad, OptState.init(pad, cams, pts_pad), cfg)
    assert (got.itno, got.flag) == (ref.itno, ref.flag)
    np.testing.assert_allclose(float(got.ex_l2), float(ref.ex_l2), rtol=1e-5)
    np.testing.assert_allclose(got.cams.numpy(), ref.cams.numpy(),
                               rtol=1e-4, atol=1e-5)
    assert float(got.pts[tp.n_pts:].abs().max()) == 0.0
    assert float(got.ex_l2) < float(OptState.init(pa, cams, pts).ex_l2)


@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_padded_tr_run_xla_matches_unpadded(schur):
    """Four TR iterations in float64 (the XLA form) on the padded shard
    against the unpadded one: the same iterations and flag, final L2 to
    1e-9 relative. Named deviation: the reference's XLA-form TR sums
    |J x|^2 over the padding too (its A and B come unmasked from
    jacobians); the port excludes the padded rows, as the reference's
    kernel branch does."""
    from psba_tpu_torch.solvers import OptState, SolverConfig
    from psba_tpu_torch.solvers.tr import tr_run

    f64 = torch.float64
    pa, pad, tp = _shards(schur, dt=f64)
    t = lambda a: torch.as_tensor(a, dtype=f64)
    cams, pts = t(tp.cams), t(tp.pts)
    pts_pad = torch.cat([pts, torch.zeros(3, 3, dtype=f64)])
    cfg = SolverConfig.for_dtype(f64, max_iters=4, damping="additive")
    ref = tr_run(pa, OptState.init(pa, cams, pts), cfg)
    got = tr_run(pad, OptState.init(pad, cams, pts_pad), cfg)
    assert (got.itno, got.flag) == (ref.itno, ref.flag)
    np.testing.assert_allclose(float(got.ex_l2), float(ref.ex_l2), rtol=1e-9)
    assert float(got.pts[tp.n_pts:].abs().max()) == 0.0

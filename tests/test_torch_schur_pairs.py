"""The pair products of the Schur complement (ops.schur_pairs): the bucket
offsets ProblemArrays carries for them, on the CPU, and the CUDA kernel
csrc/schur_pairs.cu against its plain version and a float64 sum, on the
card.

The card tests are marked `gpu` and skip, with their reason, where torch
sees no CUDA device. Run them on the card with

    python -m pytest tests/test_torch_schur_pairs.py -q --noconftest

This file imports no JAX: the CPU tests hold the kernel path's S against
the port's own former pair product, which tests/test_torch_pairs.py holds
against the reference.
"""

import dataclasses

import numpy as np
import pytest
import torch

from psba_tpu_torch.core.schur import schur_S
from psba_tpu_torch.io import synthetic_problem
from psba_tpu_torch.ops import schur_pairs as sp
from psba_tpu_torch.solvers import ProblemArrays


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double().cpu() - b.double().cpu()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30).cpu())


def _pairs(C, counts, O=500, pad=0, seed=0):
    """A bucket-sorted pair list with `counts` pairs in the buckets (cycled
    over the C*C buckets; 0 leaves a bucket empty) and `pad` padding
    entries (bucket C*C) at its end, random observation numbers below O,
    and random Y, W [O, 6, 3]. Returns (Y, W, o1, o2, bucket) on the CPU,
    the list as int64 tensors."""
    rng = np.random.default_rng(seed)
    n = np.resize(np.asarray(counts, np.int64), C * C)
    bucket = np.concatenate([np.repeat(np.arange(C * C), n),
                             np.full(pad, C * C)]).astype(np.int64)
    N = len(bucket)
    o1 = rng.integers(0, O, N)
    o2 = rng.integers(0, O, N)
    Y = torch.as_tensor(rng.standard_normal((O, 6, 3)), dtype=torch.float32)
    W = torch.as_tensor(rng.standard_normal((O, 6, 3)), dtype=torch.float32)
    t = lambda a: torch.as_tensor(a, dtype=torch.int64)
    return Y, W, t(o1), t(o2), t(bucket)


def _reference64(Y, W, o1, o2, bucket, C):
    """-sum of Y_o1 W_o2^T by bucket in float64, in S's layout; padding
    dropped."""
    keep = bucket < C * C
    prod = torch.matmul(Y.double()[o1[keep]],
                        W.double()[o2[keep]].transpose(1, 2))
    off = torch.zeros((C * C, 6, 6), dtype=torch.float64)
    off.index_add_(0, bucket[keep], prod)
    return (-off).reshape(C, C, 6, 6).permute(0, 2, 1, 3).reshape(6 * C,
                                                                   6 * C)


def _offsets(bucket, C):
    return sp.pair_offsets(bucket, C)


# lists of the card tests and the CPU layout test: a ring-like list with
# empty buckets; buckets many times 32 pairs long; a padded shard list; one
# camera, its bucket above and under the kernel's 128-pair limit of a
# short tile (eight lanes a bucket); tiles of four buckets at that limit
_LISTS = {
    "empty_buckets": dict(C=7, counts=[0, 3, 0, 0, 1, 40, 0, 33, 0, 2]),
    "long_buckets": dict(C=5, counts=[1100, 0, 31, 32, 97, 257, 0, 64]),
    "padded_shard": dict(C=6, counts=[5, 0, 70, 1, 0], pad=37),
    "one_camera": dict(C=1, counts=[300]),
    "one_camera_short": dict(C=1, counts=[100]),
    "tile_edges": dict(C=5, counts=[128, 7, 0, 1, 129, 2, 3, 4, 8, 9, 16,
                                    17]),
}


def _list(name, seed=0):
    kw = dict(_LISTS[name])
    C = kw.pop("C")
    return C, _pairs(C, seed=seed, **kw)


# ------------------------------------------------------------ CPU: offsets

@pytest.mark.parametrize("dtype, backend, built", [
    (torch.float32, "auto", True), (torch.float32, "pallas", True),
    (torch.float64, "pallas", True), (torch.float64, "auto", False),
    (torch.float32, "xla", False)])
def test_from_problem_builds_pair_start_on_the_kernel_path(dtype, backend,
                                                           built):
    """from_problem gives the pair encoding pair_start = np.searchsorted(
    pair_bucket, arange(C*C + 1)) on the kernel path and None on the XLA
    form; the dense encoding never has it."""
    prob = synthetic_problem(n_cams=6, n_pts=150, seed=3)
    pa = ProblemArrays.from_problem(prob, dtype=dtype, device="cpu",
                                    schur="pairs", backend=backend)
    if not built:
        assert pa.pair_start is None
    else:
        C = prob.n_cams
        want = np.searchsorted(prob.with_pairs().pair_bucket,
                               np.arange(C * C + 1))
        assert pa.pair_start.dtype == torch.int64
        np.testing.assert_array_equal(pa.pair_start.numpy(), want)
        assert int(pa.pair_start[-1]) == pa.pair_o1.shape[0]
    dense = ProblemArrays.from_problem(prob, dtype=dtype, device="cpu",
                                       schur="dense", backend=backend)
    assert dense.pair_start is None


def test_from_problem_refuses_an_unsorted_pair_list():
    """A pair list out of bucket order raises on the kernel path, whose
    kernel reads each bucket as one run; the XLA form, which sums by the
    list's own buckets, takes it."""
    prob = synthetic_problem(n_cams=5, n_pts=80, seed=1).with_pairs()
    order = np.random.default_rng(0).permutation(len(prob.pair_o1))
    shuffled = dataclasses.replace(
        prob, pair_o1=prob.pair_o1[order], pair_o2=prob.pair_o2[order],
        pair_bucket=prob.pair_bucket[order])
    with pytest.raises(ValueError, match="sorted by bucket"):
        ProblemArrays.from_problem(shuffled, dtype=torch.float32,
                                   device="cpu", schur="pairs")
    xla = ProblemArrays.from_problem(shuffled, dtype=torch.float32,
                                     device="cpu", schur="pairs",
                                     backend="xla")
    assert xla.pair_start is None


@pytest.mark.parametrize("n_shards", [2, 3])
def test_shard_offsets_skip_the_padding(n_shards):
    """Each rank's local_arrays (padded pair lists, bucket C*C at their
    end) carry offsets that end where the padding starts, and its S with
    them equals its S over the list's own buckets, bit for bit."""
    from psba_tpu_torch.parallel.distributed import slice_local
    from psba_tpu_torch.parallel.shard import local_arrays, shard_problem

    prob = synthetic_problem(n_cams=6, n_pts=150, seed=3)
    C = prob.n_cams
    sh = shard_problem(prob, n_shards, schur="pairs")
    padded = 0
    for rank in range(n_shards):
        loc = slice_local(sh, rank)
        pa = local_arrays(loc, torch.float32, "cpu")
        real = int(np.sum(loc.pair_bucket < C * C))
        padded += len(loc.pair_bucket) - real
        assert int(pa.pair_start[-1]) == real
        np.testing.assert_array_equal(
            pa.pair_start.numpy(),
            np.searchsorted(loc.pair_bucket, np.arange(C * C + 1)))
        g = torch.Generator().manual_seed(rank)
        O = pa.n_obs
        Y, W = torch.randn(O, 6, 3, generator=g), torch.randn(O, 6, 3,
                                                              generator=g)
        U = torch.randn(C, 6, 6, generator=g)
        args = (U, Y, W, pa.pair_o1, pa.pair_o2, pa.pair_bucket, C)
        assert torch.equal(schur_S(*args, pair_start=pa.pair_start),
                           schur_S(*args))
    assert padded > 0


# ------------------------------------------------------- CPU: schur_S bits

@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("schur_from", ["from_problem", "from_reference"])
def test_schur_S_with_pair_start_same_bits_on_cpu(seed, schur_from):
    """On the CPU, schur_S with pair_start (ops.schur_pairs' plain version)
    gives the bits of schur_S over pair_bucket, from either constructor."""
    from psba_tpu_torch.convert import from_reference

    prob = synthetic_problem(n_cams=7, n_pts=200, seed=seed)
    if schur_from == "from_problem":
        pa = ProblemArrays.from_problem(prob, dtype=torch.float32,
                                        device="cpu", schur="pairs")
    else:
        p = prob.with_pairs()
        fields = {k: getattr(p, k) for k in (
            "K", "q0", "obs", "cam_idx", "pt_idx", "pair_o1", "pair_o2",
            "pair_bucket")}
        pa, _, _ = from_reference(fields, p.cams.astype(np.float32),
                                  p.pts.astype(np.float32), device="cpu")
    C, O = prob.n_cams, prob.n_obs
    g = torch.Generator().manual_seed(seed)
    Y, W = torch.randn(O, 6, 3, generator=g), torch.randn(O, 6, 3,
                                                          generator=g)
    U = torch.randn(C, 6, 6, generator=g)
    args = (U, Y, W, pa.pair_o1, pa.pair_o2, pa.pair_bucket, C)
    assert pa.pair_start is not None
    assert torch.equal(schur_S(*args, pair_start=pa.pair_start),
                       schur_S(*args))


@pytest.mark.parametrize("name", list(_LISTS))
def test_plain_version_layout_against_float64(name):
    """schur_pairs on CPU tensors: S_off[6k+i, 6l+j] = -sum of (Y_o1
    W_o2^T)[i, j] over bucket kC+l, padding dropped, within float32
    rounding of a float64 sum (1e-5 of max |S|: bucket sums of up to 1,100
    products of unit normals); schur_S adds U on the diagonal blocks only."""
    C, (Y, W, o1, o2, bucket) = _list(name)
    start = _offsets(bucket, C)
    got = sp.schur_pairs(Y, W, o1, o2, bucket, start, C)
    want = _reference64(Y, W, o1, o2, bucket, C)
    assert got.shape == (6 * C, 6 * C) and got.dtype == torch.float32
    assert _rel(got, want) < 1e-5
    U = torch.randn(C, 6, 6, generator=torch.Generator().manual_seed(5))
    S = schur_S(U, Y, W, o1, o2, bucket, C, pair_start=start)
    blk = torch.zeros(6 * C, 6 * C, dtype=torch.float64)
    for k in range(C):
        blk[6 * k:6 * k + 6, 6 * k:6 * k + 6] = U[k].double()
    assert _rel(S, want + blk) < 1e-5


def _plain_schur_pairs(Y, W, o1, o2, bucket, _start, C):
    """ops.schur_pairs.schur_pairs' signature, the plain version's work:
    the batched product and bucket sum over the list's own buckets."""
    return sp.schur_pairs_plain(Y, W, o1, o2, bucket, C)


def _lm_setup(device, n_cams, n_pts, seed):
    from psba_tpu_torch.solvers import OptState, SolverConfig
    from psba_tpu_torch.solvers import resolve_damping

    prob = synthetic_problem(n_cams=n_cams, n_pts=n_pts, seed=seed)
    pa = ProblemArrays.from_problem(prob, dtype=torch.float32,
                                    device=device, schur="pairs")
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    cams, pts = t(prob.cams), t(prob.pts)
    cfg = resolve_damping(SolverConfig.for_dtype(
        torch.float32, lm_switch_count=10_000, record_history=True), pa,
        cams, pts)
    return pa, cfg, OptState.init(pa, cams, pts)


def test_lm_run_on_cpu_follows_the_input(monkeypatch):
    """lm_run on the pair kernel path calls ops.schur_pairs once a try
    (one residual_l2 call a try), and on the CPU its run has the bits of
    an explicit plain run (the batched product over pair_bucket)."""
    from psba_tpu_torch.core import schur as schur_mod
    from psba_tpu_torch.solvers import lm as lm_mod

    pa, cfg, st0 = _lm_setup("cpu", 6, 150, 3)
    calls = dict(schur_pairs=0, residual_l2=0)

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    with monkeypatch.context() as m:
        m.setattr(schur_mod, "schur_pairs",
                  counted("schur_pairs", schur_mod.schur_pairs))
        m.setattr(lm_mod, "residual_l2",
                  counted("residual_l2", lm_mod.residual_l2))
        a = lm_mod.lm_run(pa, st0, cfg, iter_cap=4)
    assert calls["schur_pairs"] == calls["residual_l2"] >= 4
    monkeypatch.setattr(schur_mod, "schur_pairs", _plain_schur_pairs)
    b = lm_mod.lm_run(pa, st0, cfg, iter_cap=4)
    assert a.itno == b.itno and a.flag == b.flag
    np.testing.assert_array_equal(a.history, b.history)
    assert torch.equal(a.cams, b.cams) and torch.equal(a.pts, b.pts)


@pytest.mark.parametrize("run", ["lm_run", "tr_run"])
def test_kernel_path_refuses_pairs_without_pair_start(run):
    """A pair ProblemArrays without pair_start (built by hand or with
    dataclasses.replace) is refused on the kernel path, which would
    otherwise quietly take the batched product; the XLA form runs it."""
    from psba_tpu_torch.solvers import lm, tr
    from psba_tpu_torch.solvers.types import use_kernels

    pa, cfg, st0 = _lm_setup("cpu", 5, 80, 1)
    fn = getattr(lm if run == "lm_run" else tr, run)
    stripped = dataclasses.replace(pa, pair_start=None)
    assert use_kernels(cfg, torch.float32)
    with pytest.raises(ValueError, match="pair_start"):
        fn(stripped, st0, cfg, iter_cap=1)
    xla = fn(stripped, st0, cfg._replace(backend="xla"), iter_cap=1)
    assert xla.itno == 1


# ------------------------------------------------------------- the card

@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_LISTS))
def test_kernel_matches_plain_and_float64(cuda, name):
    """The kernel against its plain version on the card and a float64 sum
    of the same pairs: 1e-5 of max |S| (bucket sums of up to 1,100 float32
    products of unit normals, in the kernel's lane order against
    index_put_'s); every entry written, empty buckets as zero; one launch a
    call, the same bits on two calls."""
    C, (Y, W, o1, o2, bucket) = _list(name)
    Yc, Wc, o1c, o2c, bc = (x.to(cuda) for x in (Y, W, o1, o2, bucket))
    start = _offsets(bc, C)
    before = sp.schur_pairs.launches
    got = sp.schur_pairs(Yc, Wc, o1c, o2c, bc, start, C)
    torch.cuda.synchronize()
    assert sp.schur_pairs.launches == before + 1
    assert got.shape == (6 * C, 6 * C) and bool(torch.isfinite(got).all())
    plain = sp.schur_pairs_plain(Yc, Wc, o1c, o2c, bc, C)
    want = _reference64(Y, W, o1, o2, bucket, C)
    assert _rel(got, plain) < 1e-5 and _rel(got, want) < 1e-5
    empty = (want.reshape(C, 6, C, 6).abs().sum((1, 3)) == 0).to(cuda)
    assert bool((got.reshape(C, 6, C, 6).abs().sum((1, 3))[empty] == 0)
                .all())
    again = sp.schur_pairs(Yc, Wc, o1c, o2c, bc, start, C)
    assert sp.schur_pairs.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.gpu
def test_kernel_refuses_what_it_does_not_take(cuda):
    """float64, int32 indices, offsets of the wrong length, and CPU
    offsets with CUDA blocks raise before any launch."""
    C, (Y, W, o1, o2, bucket) = _list("empty_buckets")
    Yc, Wc, o1c, o2c, bc = (x.to(cuda) for x in (Y, W, o1, o2, bucket))
    start = _offsets(bc, C)
    before = sp.schur_pairs.launches
    with pytest.raises(TypeError):
        sp.schur_pairs(Yc.double(), Wc.double(), o1c, o2c, bc, start, C)
    with pytest.raises(ValueError, match="int64"):
        sp.schur_pairs(Yc, Wc, o1c.int(), o2c, bc, start, C)
    with pytest.raises(ValueError, match="shapes"):
        sp.schur_pairs(Yc, Wc, o1c, o2c, bc, start[:-1], C)
    with pytest.raises(ValueError, match="int64"):
        sp.schur_pairs(Yc, Wc, o1c, o2c, bc, start.cpu(), C)
    assert sp.schur_pairs.launches == before


@pytest.mark.gpu
def test_pairs_lm_run_on_card_launches_once_a_try(cuda, monkeypatch):
    """A pair-path lm_run(iter_cap=3) on the card launches the kernel once
    a try (one residual_l2 launch a try) and lands, with the same
    iterations and flag, within proj_err 1.5e-4 (the benchmark's limit) of
    an explicit plain run, the same lm_run with ops.schur_pairs' plain
    version in place of the kernel: |x^ - x^_plain| over |x^_plain -
    x^_0| of every predicted image point."""
    from psba_tpu_torch.core import schur as schur_mod
    from psba_tpu_torch.ops import linearize_stream as ls
    from psba_tpu_torch.solvers.lm import lm_run

    pa, cfg, st0 = _lm_setup(cuda, 13, 700, 2)
    k0, r0 = sp.schur_pairs.launches, ls.residual_l2.launches
    a = lm_run(pa, st0, cfg, iter_cap=3)
    tries = ls.residual_l2.launches - r0
    assert tries >= 3 and sp.schur_pairs.launches - k0 == tries
    k1 = sp.schur_pairs.launches
    monkeypatch.setattr(schur_mod, "schur_pairs", _plain_schur_pairs)
    b = lm_run(pa, st0, cfg, iter_cap=3)
    assert sp.schur_pairs.launches == k1
    assert a.itno == b.itno == 3 and a.flag == b.flag
    err = float((a.ex - b.ex).norm() / (b.ex - st0.ex).norm())
    assert err < 1.5e-4, err

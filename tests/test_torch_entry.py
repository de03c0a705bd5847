"""Port against reference: the direct lm_run entry, the sharded repeats
runner and quat_normalize_vec, on the CPU.

  - The direct entry, ProblemArrays.from_problem -> OptState.init ->
    resolve_damping -> lm_run, as the reference's bench drives it: with no
    device the constructors (from_problem, convert.from_reference,
    convert.state_from_reference) go to the card and raise without one,
    never returning CPU tensors; with device="cpu" the run meets the
    reference's in float64 (both the XLA form) on both encodings.
  - parallel.shard.make_sharded_lm_repeat on two gloo ranks against the
    reference's make_sharded_runners + make_sharded_lm_repeat on a (2,)
    mesh of the conftest's virtual CPU devices, and on one rank against
    lm_run bit for bit.
  - models.quat_normalize_vec against the reference's.

JAX is imported inside the test functions only. Tolerances are stated
beside each test; the test that starts processes gives run_ranks a
timeout of 120 s, so a hung rank fails it.
"""

import numpy as np
import pytest
import torch

from tests import _torch_mesh_worker as worker

RANKS_TIMEOUT = 120
F64 = torch.float64


def _problems():
    """(psba_tpu problem, psba_tpu_torch problem), each made by its own
    package from one seed: 6 cameras, 150 points."""
    import psba_tpu.io as jio
    import psba_tpu_torch.io as tio

    return (jio.synthetic_problem(n_cams=6, n_pts=150, seed=3),
            tio.synthetic_problem(n_cams=6, n_pts=150, seed=3))


def _fixed_work_cfg(config_cls, **kw):
    """The reference's sharded repeat test config (no early stop, no switch
    to TR, additive damping), tests/test_sharding.py."""
    return config_cls(max_iters=64, stop_thresh=1e-30, lm_switch_count=10_000,
                      damping="additive", **kw)


# ---------------------------------------------------- the default device

def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _from_problem(prob, **kw):
    from psba_tpu_torch.solvers import ProblemArrays

    return ProblemArrays.from_problem(prob, dtype=F64, **kw)


def _from_reference(prob, **kw):
    from psba_tpu_torch.convert import from_reference

    pa = {k: getattr(prob, k) for k in ("K", "q0", "obs", "cam_idx",
                                        "pt_idx", "pair_o1", "pair_o2",
                                        "pair_bucket")}
    return from_reference(pa, prob.cams, prob.pts, **kw)


def _state_from_reference(prob, **kw):
    from psba_tpu_torch.convert import state_from_reference

    st = dict(cams=prob.cams, pts=prob.pts,
              ex=np.zeros((prob.n_obs, 2)), ex_l2=np.float64(1.0), itno=0,
              flag=None, history=None, aux=None)
    return state_from_reference(st, **kw)


_CONSTRUCTORS = {"from_problem": _from_problem,
                 "from_reference": _from_reference,
                 "state_from_reference": _state_from_reference}


def _tensors(obj):
    """Every tensor of a ProblemArrays / OptState or a tuple of them."""
    import dataclasses

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, tuple) and not dataclasses.is_dataclass(obj):
        return [t for x in obj for t in _tensors(x)]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in _tensors(getattr(obj, f.name))]
    return []


@pytest.mark.parametrize("name", list(_CONSTRUCTORS))
def test_constructor_without_device_needs_a_card(name, monkeypatch):
    """With no device and no card each constructor raises and names
    device="cpu"; it never hands back CPU tensors."""
    _, tp = _problems()
    tp = tp.with_pairs()
    _no_card(monkeypatch)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _CONSTRUCTORS[name](tp)


@pytest.mark.parametrize("name", list(_CONSTRUCTORS))
def test_constructor_cpu_when_asked(name):
    """device="cpu" puts every tensor on the CPU (the plain versions)."""
    _, tp = _problems()
    got = _tensors(_CONSTRUCTORS[name](tp.with_pairs(), device="cpu"))
    assert got and all(t.device.type == "cpu" for t in got)


def test_resolve_device(monkeypatch):
    """None is the CUDA device; a named device is kept; a CUDA device
    where torch sees none raises and names device="cpu"."""
    from psba_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None, "x") == torch.device("cuda")
    assert resolve_device("cuda:1", "x") == torch.device("cuda", 1)
    assert resolve_device("cpu", "x") == torch.device("cpu")
    _no_card(monkeypatch)
    assert resolve_device(torch.device("cpu"), "x") == torch.device("cpu")
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match='who runs.*device="cpu"'):
            resolve_device(dev, "who")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(_CONSTRUCTORS))
def test_constructor_on_the_card_by_default(name):
    """With a card and no device every tensor lands on CUDA."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, tp = _problems()
    got = _tensors(_CONSTRUCTORS[name](tp.with_pairs()))
    assert got and all(t.device.type == "cuda" for t in got)


# ------------------------------------------------------ the direct entry

@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_direct_lm_run_matches_reference(schur):
    """from_problem -> OptState.init -> resolve_damping -> lm_run(iter_cap
    = 5) in float64 (the XLA form in both packages; device="cpu") against
    the reference's same calls: the resolved damping, the iterations and
    flag, final L2 to 1e-9 relative, cameras to 1e-9 relative of their
    largest entry."""
    import jax.numpy as jnp

    from psba_tpu.solvers import SolverConfig as JConfig
    from psba_tpu.solvers.lm import lm_run as jlm_run
    from psba_tpu.solvers.types import OptState as JOptState
    from psba_tpu.solvers.types import ProblemArrays as JProblemArrays
    from psba_tpu.solvers.types import resolve_damping as jresolve
    from psba_tpu_torch.solvers import (
        OptState,
        ProblemArrays,
        SolverConfig,
        resolve_damping,
    )
    from psba_tpu_torch.solvers.lm import lm_run

    jp, tp = _problems()
    jpa = JProblemArrays.from_problem(jp, dtype=jnp.float64, schur=schur)
    jc, jx = (jnp.asarray(a, jnp.float64) for a in (jp.cams, jp.pts))
    jcfg = jresolve(JConfig(max_iters=64, stop_thresh=1e-30,
                            lm_switch_count=10_000), jpa, jc, jx)
    ref = jlm_run(jpa, JOptState.init(jpa, jc, jx), jcfg, iter_cap=5)

    pa = ProblemArrays.from_problem(tp, dtype=F64, schur=schur,
                                    device="cpu")
    tc, tx = (torch.as_tensor(a, dtype=F64) for a in (tp.cams, tp.pts))
    cfg = resolve_damping(SolverConfig(max_iters=64, stop_thresh=1e-30,
                                       lm_switch_count=10_000), pa, tc, tx)
    got = lm_run(pa, OptState.init(pa, tc, tx), cfg, iter_cap=5)
    assert cfg.damping == jcfg.damping
    assert (got.itno, got.flag) == (int(ref.itno), int(ref.flag))
    np.testing.assert_allclose(float(got.ex_l2), float(ref.ex_l2),
                               rtol=1e-9)
    ref_c = np.asarray(ref.cams)
    np.testing.assert_allclose(got.cams.numpy(), ref_c, rtol=0,
                               atol=1e-9 * np.abs(ref_c).max())


# ------------------------------------------------ the sharded repeat runner

@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_sharded_lm_repeat_matches_reference(schur):
    """make_sharded_lm_repeat on two gloo ranks (lm_repeat_rank, float64,
    iter_cap 5, repeats 3) against the reference's runner on a (2,) mesh
    of virtual CPU devices, both on shard_problem(prob, 2): total_itno 15
    exactly on both ranks, acc_l2 the same on both ranks, within 1e-9
    relative of the reference's and within 1e-12 relative of 3 x the port's
    single run."""
    import jax
    import jax.numpy as jnp

    from psba_tpu.parallel.shard import make_sharded_lm_repeat as j_repeat
    from psba_tpu.parallel.shard import make_sharded_runners
    from psba_tpu.parallel.shard import shard_problem as j_shard
    from psba_tpu.solvers import SolverConfig as JConfig
    from psba_tpu_torch.parallel.distributed import run_ranks
    from psba_tpu_torch.solvers import SolverConfig

    assert len(jax.devices()) >= 2
    jp, tp = _problems()
    jcfg = _fixed_work_cfg(JConfig)
    sp = j_shard(jp, 2, schur=schur)
    mesh = jax.make_mesh((2,), ("obs",))
    pa, cams0, pts0, init_s, _, _ = make_sharded_runners(
        sp, jcfg, mesh, dtype=jnp.float64)
    ref_acc, ref_itno = j_repeat(sp, jcfg, mesh)(
        pa, init_s(pa, cams0, pts0), jnp.int32(5), jnp.int32(3))
    assert int(ref_itno) == 15

    out = run_ranks(["cpu", "cpu"], "gloo", worker.lm_repeats,
                    timeout=RANKS_TIMEOUT, repeats=3, prob=tp,
                    cfg=_fixed_work_cfg(SolverConfig), iter_cap=5,
                    dtype=F64, schur=schur)
    (rep, one), (rep1, _) = out
    assert rep["total_itno"] == rep1["total_itno"] == 15
    assert one["total_itno"] == 5
    assert rep["acc_l2"] == rep1["acc_l2"]
    np.testing.assert_allclose(rep["acc_l2"], float(ref_acc), rtol=1e-9)
    np.testing.assert_allclose(rep["acc_l2"], 3.0 * one["acc_l2"],
                               rtol=1e-12)


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
def test_one_rank_lm_repeat_same_bits_as_lm_run(dt):
    """lm_repeat_rank on one gloo rank in the calling process (iter_cap 3,
    repeats 3; float32 runs the kernels' plain versions): total_itno 9 and
    acc_l2 the bits of 0 + l2 + l2 + l2, l2 the final L2 of from_problem ->
    OptState.init -> lm_run with no mesh."""
    from psba_tpu_torch.parallel.distributed import lm_repeat_rank, run_ranks
    from psba_tpu_torch.parallel.shard import resolve_damping_host
    from psba_tpu_torch.solvers import OptState, ProblemArrays, SolverConfig
    from psba_tpu_torch.solvers.lm import lm_run

    _, tp = _problems()
    cfg = SolverConfig.for_dtype(dt, max_iters=64, lm_switch_count=10_000)
    (got,) = run_ranks(["cpu"], "gloo", lm_repeat_rank, prob=tp, cfg=cfg,
                       iter_cap=3, repeats=3, dtype=dt, schur="dense")
    pa = ProblemArrays.from_problem(tp, dtype=dt, schur="dense",
                                    device="cpu")
    t = lambda a: torch.as_tensor(a, dtype=dt)
    st = lm_run(pa, OptState.init(pa, t(tp.cams), t(tp.pts)),
                resolve_damping_host(cfg, tp, dt, "cpu"), iter_cap=3)
    want = torch.zeros((), dtype=dt)
    for _ in range(3):
        want = want + st.ex_l2
    assert st.itno == 3 and got["total_itno"] == 9
    assert got["acc_l2"] == float(want)


# ------------------------------------------------------- quat_normalize_vec

@pytest.mark.parametrize("shape", [(3, 5, 4), (4,), (7, 4)])
def test_quat_normalize_vec_matches_reference(shape):
    """float64 quaternions from a seeded generator, scaled off the unit
    sphere, a third of the scalars negative (and one exactly zero): the
    vector part and the normalized quaternion to 1e-12 of the reference's;
    the scalar part non-negative, the norm 1."""
    import jax.numpy as jnp

    from psba_tpu.models import quat_normalize_vec as j_qnv
    from psba_tpu_torch.models import quat_normalize_vec

    rng = np.random.default_rng(11)
    q = rng.standard_normal(shape) * rng.uniform(0.2, 5.0, shape[:-1] + (1,))
    flat = q.reshape(-1, 4)
    flat[::3, 0] = -np.abs(flat[::3, 0])
    flat[-1, 0] = 0.0
    ref_v, ref_q = j_qnv(jnp.asarray(q))
    got_v, got_q = quat_normalize_vec(torch.as_tensor(q))
    assert got_v.shape == shape[:-1] + (3,) and got_q.shape == shape
    assert got_v.dtype == got_q.dtype == F64
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(ref_q), rtol=0,
                               atol=1e-12)
    assert (got_q[..., 0] >= 0).all()
    np.testing.assert_allclose(torch.linalg.vector_norm(got_q, dim=-1),
                               1.0, atol=1e-12)


def test_quat_normalize_vec_keeps_dtype():
    """A float32 input gives float32 outputs on its own device."""
    from psba_tpu_torch.models import quat_normalize_vec

    q = torch.tensor([[-2.0, 1.0, 0.0, 0.0], [0.0, 0.0, 3.0, 4.0]])
    v, qn = quat_normalize_vec(q)
    assert v.dtype == qn.dtype == torch.float32 and v.device == q.device
    torch.testing.assert_close(qn, torch.tensor([[0.8944272, -0.4472136,
                                                  0.0, 0.0],
                                                 [0.0, 0.0, 0.6, 0.8]]))

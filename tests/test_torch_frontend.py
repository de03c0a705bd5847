"""Port against reference: the front-end (psba_tpu_torch.frontend against
psba_tpu.frontend) on CPU tensors, on the renders of tests/test_frontend.py.

Tolerances: corners and descriptors 1e-5 (both packages compute the same
float32 filters, their sums in another order), matches exactly; E up to
its sign (the SVD's), R and t 1e-5 in float32, 1e-10 in float64; the
triangulated points 1e-4 relative; the pipelines without RANSAC give the
same BAProblem (the same observations; poses 1e-4, points 1e-4 relative up
to the median depth, in proportion to the depth beyond it), and so do the
pipelines with RANSAC given the reference's minimal sets (its jax.random
draws, passed to the port's `sample_idx`). With the port's own draws the
consensus sets differ, and the port's solve must take the problem under
1 px RMS.

Trap of the comparison: suppressed and border pixels score 0, and the
top-k's order among equal scores is each library's own, so corners are
compared where the score is positive, as sets ordered by score and then
by index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psba_tpu.frontend import features as jf
from psba_tpu.frontend import matching as jm
from psba_tpu.frontend import pipeline as jp
from psba_tpu.frontend import twoview as jt
from psba_tpu_torch.frontend import features as tf
from psba_tpu_torch.frontend import matching as tm
from psba_tpu_torch.frontend import pipeline as tp
from psba_tpu_torch.frontend import twoview as tt
from tests.test_frontend import _render, _synthetic_two_view

K = [200.0, 80.0, 60.0, 1.0, 0.0]


def _roty(ang):
    return np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                     [-np.sin(ang), 0, np.cos(ang)]])


def _project(X, R, t):
    Xc = X @ R.T + t
    return Xc[:, :2] / Xc[:, 2:3] * K[0] + np.array(K[1:3])


def _pair_images(seed=3, n=40, swap=0):
    """test_frontend's two-view scene: 40 planted points, camera 2 turned
    0.08 rad about y and moved 0.6 to the side; `swap` second-view blobs
    exchanged to make bad matches."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1.2, -0.9, 4], [1.2, 0.9, 8], size=(n, 3))
    uv1 = _project(X, np.eye(3), np.zeros(3))
    uv2 = _project(X, _roty(0.08), np.array([-0.6, 0.0, 0.0]))
    if swap:
        s = rng.choice(n, swap, replace=False)
        uv2[s] = uv2[np.roll(s, 1)]
    return _render(uv1), _render(uv2)


def _sequence_images(n_views=4):
    """test_frontend's 4-view sequence: 60 points, 0.05 rad and 0.4 to the
    side per view."""
    rng = np.random.default_rng(11)
    X = rng.uniform([-1.4, -1.0, 4], [1.4, 1.0, 8], size=(60, 3))
    return [_render(_project(X, _roty(0.05 * i),
                             np.array([-0.4 * i, 0.0, 0.0])))
            for i in range(n_views)]


def _positive(xy, score):
    """Corners with a positive score, ordered by score (descending), then
    by pixel index."""
    xy, score = np.asarray(xy), np.asarray(score)
    keep = score > 0
    xy, score = xy[keep], score[keep]
    order = np.lexsort((xy[:, 1] * 1e5 + xy[:, 0], -score))
    return xy[order], score[order], np.flatnonzero(keep)[order]


def _images():
    rng = np.random.default_rng(0)
    pts = rng.uniform([10, 10], [150, 110], size=(20, 2))
    shifted = np.random.default_rng(1).uniform([20, 20], [130, 90], (25, 2))
    return [_render(pts), _render(shifted, rng=np.random.default_rng(5)),
            _render(shifted + [6.0, 3.0], rng=np.random.default_rng(6)),
            *_pair_images()]


@pytest.mark.parametrize("which", range(5))
def test_corners_and_descriptors_match_reference(which):
    img = _images()[which]
    jxy, js, jd = map(np.asarray, jf.detect_and_describe(jnp.array(img),
                                                          k=64))
    txy, ts, td = (a.numpy() for a in tf.detect_and_describe(
        img, k=64, device="cpu"))
    assert txy.dtype == np.float32 and td.shape == jd.shape
    a, b = _positive(jxy, js), _positive(txy, ts)
    assert len(a[0]) == len(b[0]) > 10
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_allclose(a[1], b[1], rtol=1e-5)
    np.testing.assert_allclose(jd[a[2]], td[b[2]], atol=1e-5)


def test_describe_clamps_patches_into_the_image():
    """Corners at (0, 0) and at the far corner take the clamped patch, as
    lax.dynamic_slice does."""
    img = _images()[0]
    xy = np.array([[0, 0], [2, 3], [159, 119], [80, 60]], np.float32)
    ref = np.asarray(jf.describe(jnp.array(img), jnp.array(xy)))
    got = tf.describe(img, torch.as_tensor(xy), device="cpu").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_matches_equal_reference():
    imgs = _images()
    for i1, i2 in ((1, 2), (3, 4)):
        j1 = jf.detect_and_describe(jnp.array(imgs[i1]), k=64)
        j2 = jf.detect_and_describe(jnp.array(imgs[i2]), k=64)
        t1 = tf.detect_and_describe(imgs[i1], k=64, device="cpu")
        t2 = tf.detect_and_describe(imgs[i2], k=64, device="cpu")
        # the same descriptors into both matchers, then each its own
        for d1, d2, s1, s2 in ((j1[2], j2[2], j1[1], j2[1]),):
            ji, jv = jm.match_descriptors(d1, d2, s1, s2)
            ti, tv = tm.match_descriptors(*(torch.tensor(np.asarray(a))
                                            for a in (d1, d2, s1, s2)))
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        ti, tv = tm.match_descriptors(t1[2], t2[2], t1[1], t2[1])
        assert ti.dtype == torch.int32 and int(tv.sum()) >= 10
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy()[tv.numpy()],
                                      np.asarray(ji)[np.asarray(jv)])


@pytest.mark.parametrize("dt,tol", [(np.float64, 1e-10), (np.float32, 1e-5)])
def test_essential_pose_and_points_match_reference(dt, tol):
    X, R, t, x1, x2 = _synthetic_two_view()
    tdt = torch.float64 if dt == np.float64 else torch.float32
    jx1, jx2 = jnp.array(x1, dt), jnp.array(x2, dt)
    tx1, tx2 = (torch.as_tensor(x, dtype=tdt) for x in (x1, x2))
    valid = np.ones(len(x1), bool)
    jE = np.asarray(jt.essential_8pt(jx1, jx2, jnp.array(valid)))
    tE = tt.essential_8pt(tx1, tx2, torch.as_tensor(valid))
    assert tE.dtype == tdt
    sign = np.sign(np.sum(jE * tE.numpy()))
    np.testing.assert_allclose(sign * tE.numpy(), jE, atol=tol)
    # E and -E give the same pose
    jR, jtv = map(np.asarray, jt.decompose_essential(jnp.array(jE), jx1,
                                                      jx2, jnp.array(valid)))
    for E in (tE, -tE):
        tR, ttv = tt.decompose_essential(E, tx1, tx2, torch.as_tensor(valid))
        np.testing.assert_allclose(tR.numpy(), jR, atol=tol)
        np.testing.assert_allclose(ttv.numpy(), jtv, atol=tol)
    np.testing.assert_allclose(tR.numpy(), R, atol=1e-4)
    jX = np.asarray(jt.triangulate(jnp.array(jR), jnp.array(jtv), jx1, jx2))
    tX = tt.triangulate(torch.tensor(jR), torch.tensor(jtv), tx1,
                        tx2).numpy()
    assert tX.dtype == jX.dtype == np.float64
    np.testing.assert_allclose(tX, jX, rtol=1e-4)
    d = jt.sampson_sq(jnp.array(jE), jx1, jx2)
    np.testing.assert_allclose(
        tt.sampson_sq(torch.as_tensor(jE), tx1, tx2).numpy(), np.asarray(d),
        rtol=1e-4, atol=1e-12)


def test_ransac_with_reference_draws():
    """test_frontend's 20% gross outliers: the port's essential_ransac
    given the reference's jax.random minimal sets keeps the reference's
    consensus set and E (up to sign), and recovers the pose."""
    X, R, t, x1, x2 = _synthetic_two_view(n=80, seed=4)
    rng = np.random.default_rng(7)
    out = rng.choice(len(x1), 16, replace=False)
    x2 = x2.copy()
    x2[out] += rng.uniform(0.05, 0.3, (16, 2)) * rng.choice([-1.0, 1.0],
                                                             (16, 2))
    valid = np.ones(len(x1), bool)
    key = jax.random.PRNGKey(0)
    jE, jinl = jt.essential_ransac(jnp.array(x1), jnp.array(x2),
                                   jnp.array(valid), key, iters=64,
                                   thresh=2e-3)
    # the draws essential_ransac makes inside
    w = jnp.array(valid).astype(jnp.float64)
    idx = jax.random.choice(key, len(x1), shape=(64, 8), replace=True,
                            p=w / (jnp.sum(w) + 1e-9))
    tE, tinl = tt.essential_ransac(
        torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(valid),
        iters=64, thresh=2e-3, sample_idx=np.asarray(idx))
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    jE = np.asarray(jE)
    sign = np.sign(np.sum(jE * tE.numpy()))
    np.testing.assert_allclose(sign * tE.numpy(), jE, atol=1e-10)
    assert tinl.numpy()[out].sum() <= 1 and tinl.numpy().sum() >= 50
    Re, te = tt.decompose_essential(tE, torch.as_tensor(x1),
                                    torch.as_tensor(x2), tinl)
    np.testing.assert_allclose(Re.numpy(), R, atol=1e-3)
    np.testing.assert_allclose(te.numpy() / np.linalg.norm(te.numpy()),
                               t / np.linalg.norm(t), atol=1e-3)


def test_ransac_own_draws_recover_pose():
    """Without sample_idx the port draws from a seeded CPU generator: the
    same draws for the same seed, and the pose comes back."""
    X, R, t, x1, x2 = _synthetic_two_view(n=80, seed=4)
    x2 = x2.copy()
    x2[:16] += 0.2
    args = (torch.as_tensor(x1), torch.as_tensor(x2),
            torch.ones(len(x1), dtype=torch.bool))
    E, inl = tt.essential_ransac(*args, seed=3)
    E2, inl2 = tt.essential_ransac(*args, seed=3)
    assert torch.equal(E, E2) and torch.equal(inl, inl2)
    assert int(inl[:16].sum()) <= 1 and int(inl.sum()) >= 50
    Re, _ = tt.decompose_essential(E, args[0], args[1], inl)
    np.testing.assert_allclose(Re.numpy(), R, atol=1e-3)


def _assert_problems_equal(got, ref, rtol=1e-4):
    """The same observations, and the same poses and points to `rtol`. A
    point's depth carries the float32 pose's rounding (a few 1e-6 rad,
    each package's float32 sums in its own order) magnified by its depth
    over the baseline, so a point's tolerance is `rtol` up to the median
    depth and grows in proportion to its depth beyond it."""
    for f in ("cam_idx", "pt_idx", "obs", "K"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    for f in ("q0", "cams"):
        a, b = getattr(got, f), np.asarray(getattr(ref, f))
        assert a.dtype == np.float64 and a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=rtol,
                                   atol=rtol * np.abs(b).max(), err_msg=f)
    a, b = got.pts, np.asarray(ref.pts)
    assert a.dtype == np.float64 and a.shape == b.shape
    rel = np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
    z = b[:, 2]
    assert np.all(rel <= rtol * np.maximum(1.0, z / np.median(z))), rel


def test_two_view_pipeline_without_ransac_matches_reference():
    img1, img2 = _pair_images()
    ref = jp.two_view_problem(jnp.array(img1), jnp.array(img2), K,
                              n_features=128, ransac_iters=0)
    got = tp.two_view_problem(img1, img2, K, n_features=128, ransac_iters=0,
                              device="cpu")
    assert got.n_pts >= 10
    _assert_problems_equal(got, ref)


def test_sequence_pipeline_without_ransac_matches_reference():
    imgs = _sequence_images()
    ref = jp.sequence_problem([jnp.array(i) for i in imgs], K,
                              n_features=128, ransac_iters=0)
    got = tp.sequence_problem(imgs, K, n_features=128, ransac_iters=0,
                              device="cpu")
    assert got.n_cams == 4 and (np.bincount(got.pt_idx) >= 3).sum() >= 5
    _assert_problems_equal(got, ref)


def _ransac_problems(kind, **kw):
    """(reference, port) problems of test_frontend's RANSAC scenes: the
    two-view pair with 8 of 40 second-view blobs swapped, and the 4-view
    sequence."""
    if kind == "sequence":
        imgs = _sequence_images()
        return (jp.sequence_problem([jnp.array(i) for i in imgs], K,
                                    n_features=128),
                tp.sequence_problem(imgs, K, n_features=128, device="cpu",
                                    **kw))
    img1, img2 = _pair_images(seed=9, swap=8)
    return (jp.two_view_problem(jnp.array(img1), jnp.array(img2), K,
                                n_features=128, ransac_iters=64),
            tp.two_view_problem(img1, img2, K, n_features=128,
                                ransac_iters=64, device="cpu", **kw))


@pytest.mark.parametrize("kind", ["two_view_bad_matches", "sequence"])
def test_pipelines_with_ransac_match_reference(kind, monkeypatch):
    """With the reference's minimal sets (its jax.random draws for the
    same seeds, passed through essential_ransac's sample_idx) the
    pipelines give the reference's BAProblem."""
    own = tp.essential_ransac

    def reference_draws(x1, x2, valid, iters, thresh, seed):
        w = jnp.asarray(valid.numpy()).astype(jnp.float32)
        idx = jax.random.choice(jax.random.PRNGKey(seed), x1.shape[0],
                                shape=(iters, 8), replace=True,
                                p=w / (jnp.sum(w) + 1e-9))
        return own(x1, x2, valid, iters=iters, thresh=thresh,
                   sample_idx=np.asarray(idx))

    monkeypatch.setattr(tp, "essential_ransac", reference_draws)
    ref, got = _ransac_problems(kind)
    _assert_problems_equal(got, ref)


@pytest.mark.parametrize("kind", ["two_view_bad_matches", "sequence"])
def test_pipelines_with_own_ransac_draws_then_solve(kind):
    """RANSAC with the port's own draws (a seeded CPU generator): the
    consensus sets differ from the reference's, so the poses do too (on
    the sequence's last pair by about 2 degrees); the port's float32 solve
    (the kernels' plain versions) must take the problem under 1 px RMS."""
    from psba_tpu_torch import solve
    from psba_tpu_torch.solvers import SolverConfig

    ref, got = _ransac_problems(kind)
    assert got.n_cams == ref.n_cams and got.n_pts >= 10
    res = solve(got, SolverConfig.for_dtype(torch.float32, max_iters=25,
                                            lm_switch_count=1000),
                dtype=torch.float32, device="cpu")
    rms = float(np.sqrt(res.final_l2 / got.n_obs))
    print(kind, "rms", rms, "initial", np.sqrt(res.initial_l2 / got.n_obs))
    assert rms < 1.0 and res.final_l2 <= res.initial_l2


def test_frontend_needs_a_card_without_device(monkeypatch):
    """With no device named the front-end runs on CUDA; without a card it
    raises and says how to ask for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img1, img2 = _pair_images()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tp.two_view_problem(img1, img2, K)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tf.harris_corners(img1)

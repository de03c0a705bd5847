"""The port's command line, dataset registry and debug utilities against the
JAX package's.

`python -m psba_tpu_torch.cli --device cpu` runs in a subprocess on
tests/data/mini_bal.txt (and on SBA text pairs written from it with
io.bal.write_sba_text). Its default is float64, the XLA form; its final
error is held to the reference's in-process float64 solve to 1e-8
relative (float64 sums in another order). The registry must equal the
reference's, and a synthesized dataset's arrays the reference's exactly.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
MINI_BAL = str(REPO / "tests" / "data" / "mini_bal.txt")
REPORT = ("time eclipse ", "initial error: ", "final error: ",
          "total iteration: ", "flag: ")


def _cli(*args, env=None, check=True, timeout=300):
    e = dict(os.environ, PYTHONPATH=str(REPO), **(env or {}))
    out = subprocess.run(
        [sys.executable, "-m", "psba_tpu_torch.cli", *args], cwd=str(REPO),
        env=e, capture_output=True, text=True, timeout=timeout)
    if check:
        assert out.returncode == 0, out.stderr
    return out


def _json(out):
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def ref_f64():
    """The reference's in-process float64 solve of mini_bal."""
    from psba_tpu.io import bal_to_problem
    from psba_tpu.solvers.hybrid import solve

    return solve(bal_to_problem(MINI_BAL))


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One float64 CLI run with --json and the output files."""
    d = tmp_path_factory.mktemp("cli")
    out = _cli("--cams", MINI_BAL, "--bal", "--json", "--device", "cpu",
               "--out-cams", str(d / "cams.txt"), "--out-pts",
               str(d / "pts.txt"))
    return out, d


def test_cli_json_matches_reference(cli_run, ref_f64):
    out, _ = cli_run
    got = _json(out)
    assert set(got) == {"initial_error", "final_error", "initial_l2",
                        "final_l2", "rms_px", "iterations", "flag", "wall_s",
                        "phases"}
    np.testing.assert_allclose(got["final_error"], ref_f64.final_error,
                               rtol=1e-8)
    np.testing.assert_allclose(got["initial_l2"], ref_f64.initial_l2,
                               rtol=1e-12)
    assert got["iterations"] == ref_f64.iterations
    assert got["flag"] == ref_f64.flag_name
    assert [tuple(p) for p in got["phases"]] == ref_f64.phases
    assert "reader: native" in out.stderr or "reader: numpy" in out.stderr


def test_cli_writes_cams_and_pts(cli_run):
    """--out-cams / --out-pts read back: the cameras (K, the composed
    rotation as q0, t) and points they hold reproject mini_bal's
    observations to the run's final error (1e-6 relative: the files keep
    nine decimals)."""
    import torch

    from psba_tpu_torch.core.residual import error_l2, residuals
    from psba_tpu_torch.io import bal_to_problem
    from psba_tpu_torch.io.sba_text import read_cams

    out, d = cli_run
    prob = bal_to_problem(MINI_BAL)
    pts = np.loadtxt(d / "pts.txt")
    K, q0, t, _ = read_cams(str(d / "cams.txt"))
    assert pts.shape == prob.pts.shape and K.shape == prob.K.shape
    np.testing.assert_allclose(K, prob.K, atol=1e-9)
    cams = np.concatenate([np.zeros_like(t), t], axis=1)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)
    i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64)
    ex = residuals(f(K), f(q0), f(cams), f(pts), f(prob.obs),
                   i(prob.cam_idx), i(prob.pt_idx))
    err = float(torch.sqrt(error_l2(ex))) / prob.n_obs
    np.testing.assert_allclose(err, _json(out)["final_error"], rtol=1e-6)


def test_cli_report_lines():
    """Without --json: the reference program's five report lines."""
    out = _cli("--cams", MINI_BAL, "--bal", "--device", "cpu",
               "--max-iters", "5")
    lines = out.stdout.strip().splitlines()[-5:]
    for line, head in zip(lines, REPORT):
        assert line.startswith(head), (line, head)
    assert lines[3] == "total iteration: 5"
    assert float(lines[2].split(": ")[1]) < float(lines[1].split(": ")[1])


def test_cli_f32_polish():
    """--f32 --polish 2: the float32 kernel path (plain versions on the
    CPU), then two float64 LM iterations in phase "lm64"."""
    got = _json(_cli("--cams", MINI_BAL, "--bal", "--json", "--device",
                     "cpu", "--f32", "--polish", "2"))
    assert got["phases"][-1][0] == "lm64"
    assert got["iterations"] == got["phases"][-2][1] + 2
    assert got["final_l2"] < got["initial_l2"]


def test_cli_dataset_from_psba_data(tmp_path, ref_f64):
    """--dataset reads $PSBA_DATA: mini_bal written there as the SBA text
    pair of the registered "7camsvarK" (12-column cameras, 7pts.txt)."""
    from psba_tpu_torch.io import bal_to_problem
    from psba_tpu_torch.io.bal import write_sba_text

    write_sba_text(bal_to_problem(MINI_BAL), str(tmp_path / "7camsvarK.txt"),
                   str(tmp_path / "7pts.txt"))
    from psba_tpu.io import load_problem
    from psba_tpu.solvers.hybrid import solve

    ref = solve(load_problem(str(tmp_path / "7camsvarK.txt"),
                             str(tmp_path / "7pts.txt")))
    got = _json(_cli("--dataset", "7camsvarK", "--json", "--device", "cpu",
                     env={"PSBA_DATA": str(tmp_path)}))
    np.testing.assert_allclose(got["final_error"], ref.final_error,
                               rtol=1e-8)
    assert got["iterations"] == ref.iterations


@pytest.mark.parametrize("args", [("--s-precision", "high")])
def test_cli_refuses_unported_options(args):
    """The option this test used to see refused, --s-precision high, runs:
    with --f32 (the dense kernel path's plain versions on the CPU, where
    "high" is the float32 product) it meets the "highest" run exactly."""
    base = ("--cams", MINI_BAL, "--bal", "--device", "cpu", "--f32",
            "--json", "--max-iters", "12")
    got, ref = _json(_cli(*base, *args)), _json(_cli(*base))
    for k in ("final_l2", "iterations", "flag", "phases"):
        assert got[k] == ref[k], k
    assert got["final_l2"] < got["initial_l2"]


def test_cli_mesh_solver_tr_starts_in_lm():
    """--mesh 2 --solver tr, as the reference's CLI: the sharded solve
    starts in LM (--solver tr only sets lm_switch_count there), where the
    single-process --solver tr starts in TR."""
    mesh = _json(_cli("--cams", MINI_BAL, "--bal", "--json", "--device",
                      "cpu", "--mesh", "2", "--solver", "tr",
                      "--max-iters", "8", timeout=120))
    one = _json(_cli("--cams", MINI_BAL, "--bal", "--json", "--device",
                     "cpu", "--solver", "tr", "--max-iters", "8"))
    assert mesh["phases"][0][0] == "lm"
    assert one["phases"][0][0] == "tr"


def test_cli_mesh_two_cpu_processes(cli_run):
    """--mesh 2 --device cpu: the sharded solve in two gloo processes meets
    the single-device CLI run: the same phases and iterations, final error
    to 1e-9 relative (float64, sums over the shards in another order).
    The command, ranks and all, has 120 s."""
    got = _json(_cli("--cams", MINI_BAL, "--bal", "--json", "--device",
                     "cpu", "--mesh", "2", timeout=120))
    one = _json(cli_run[0])
    np.testing.assert_allclose(got["final_error"], one["final_error"],
                               rtol=1e-9)
    assert got["iterations"] == one["iterations"]
    assert got["phases"] == one["phases"]


def test_cli_mesh_refuses_checkpoint_and_polish():
    out = _cli("--cams", MINI_BAL, "--bal", "--device", "cpu", "--mesh",
               "2", "--polish", "2", check=False)
    assert out.returncode != 0 and "--mesh" in out.stderr


def test_cli_imports_no_jax():
    """main() of the CLI, run in a fresh interpreter, imports neither jax
    nor any module of psba_tpu; nor do the port's parallel modules, its
    front-end, its roofline model, its device resolver, nor the direct
    lm_run entry (from_problem -> OptState.init -> lm_run), the sharded
    repeats runner and quat_normalize_vec when they run."""
    code = (
        "import sys\n"
        "import torch\n"
        "from psba_tpu_torch import cli\n"
        "import psba_tpu_torch.parallel.distributed\n"
        "import psba_tpu_torch.parallel.shard\n"
        "import psba_tpu_torch.frontend.pipeline\n"
        "import psba_tpu_torch.utils.roofline\n"
        "import psba_tpu_torch.utils.device\n"
        "from psba_tpu_torch.io import bal_to_problem\n"
        "from psba_tpu_torch.models import quat_normalize_vec\n"
        "from psba_tpu_torch.parallel import NO_MESH\n"
        "from psba_tpu_torch.parallel.distributed import lm_repeat_rank\n"
        "from psba_tpu_torch.parallel.shard import make_sharded_lm_repeat\n"
        "from psba_tpu_torch.solvers import OptState, ProblemArrays, "
        "SolverConfig, resolve_damping\n"
        f"cli.main(['--cams', {MINI_BAL!r}, '--bal', '--device', 'cpu', "
        "'--max-iters', '3', '--json'])\n"
        "quat_normalize_vec(torch.tensor([[-2.0, 1.0, 0.0, 0.0]]))\n"
        f"p = bal_to_problem({MINI_BAL!r})\n"
        "pa = ProblemArrays.from_problem(p, dtype=torch.float32, "
        "device='cpu')\n"
        "t = lambda a: torch.as_tensor(a, dtype=torch.float32)\n"
        "cfg = resolve_damping(SolverConfig.for_dtype(torch.float32), pa, "
        "t(p.cams), t(p.pts))\n"
        "run = make_sharded_lm_repeat(cfg, NO_MESH)\n"
        "acc, itno = run(pa, OptState.init(pa, t(p.cams), t(p.pts)), 2, 2)\n"
        "assert itno == 4, itno\n"
        "bad = [m for m in sys.modules if m in ('jax', 'psba_tpu') or "
        "m.startswith(('jax.', 'jaxlib', 'psba_tpu.'))]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert _json(out)["iterations"] == 3


def test_cli_nan_checks_from_env(tmp_path):
    """PSBA_DEBUG_NANS=1 on the command line: a NaN point stops the run
    with FloatingPointError."""
    from psba_tpu_torch.io import bal_to_problem
    from psba_tpu_torch.io.bal import write_sba_text

    prob = bal_to_problem(MINI_BAL)
    pts = prob.pts.copy()
    pts[3] = np.nan
    cams, pts_path = str(tmp_path / "c.txt"), str(tmp_path / "p.txt")
    write_sba_text(dataclasses.replace(prob, pts=pts), cams, pts_path)
    out = _cli("--cams", cams, "--pts", pts_path, "--device", "cpu",
               env={"PSBA_DEBUG_NANS": "1"}, check=False)
    assert out.returncode != 0 and "FloatingPointError" in out.stderr


# --------------------------------------------------------------- datasets

def test_registry_matches_reference():
    from psba_tpu import datasets as jd
    from psba_tpu_torch import datasets as td

    assert td.names() == jd.names()
    for name in jd.names():
        assert (dataclasses.asdict(td.REGISTRY[name])
                == dataclasses.asdict(jd.REGISTRY[name])), name


def test_load_synthesized_matches_reference(tmp_path, monkeypatch):
    """load() of a cams-only set synthesizes the reference's arrays
    exactly (mini_bal's BAL-convention cameras, 600 points), and reads
    them back from its own cache file."""
    from psba_tpu import datasets as jd
    from psba_tpu_torch import datasets as td
    from psba_tpu_torch.io import bal_to_problem
    from psba_tpu_torch.io.sba_text import write_cams

    prob = bal_to_problem(MINI_BAL)
    write_cams(str(tmp_path / "tiny-cams.txt"), prob.K, prob.q0, prob.cams)
    for mod in (jd, td):
        monkeypatch.setitem(mod.REGISTRY, "tiny", mod.DatasetSpec(
            "tiny", "tiny-cams.txt", synth_pts=600, complete=False))
    ref = jd.load("tiny", data_dir=str(tmp_path), cache_dir=None)
    cache = tmp_path / "cache"
    for _ in range(2):      # synthesized, then from the cache
        got = td.load("tiny", data_dir=str(tmp_path), cache_dir=str(cache))
        for f in ("K", "q0", "cams", "pts", "obs", "cam_idx", "pt_idx"):
            a, b = getattr(got, f), getattr(ref, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert [p.name for p in cache.iterdir()] == ["tiny_s0_v2_torch.npz"]
    with pytest.raises(FileNotFoundError, match="PSBA_DATA"):
        td.load("3cams", data_dir=str(tmp_path / "none"))


# ------------------------------------------------------------ utils.debug

def test_debug_utils_match_reference(capsys):
    """first_nonfinite on a dict (keys in sorted order, as jax.tree
    flattens it) and dump_blocks' output, against the reference's."""
    import torch

    from psba_tpu.utils import debug as jdbg
    from psba_tpu_torch.utils import debug as tdbg

    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((5, 3, 3)), rng.standard_normal((4, 2))
    b[2, 1] = np.inf
    tree = {"b": b, "a": a}
    assert tdbg.first_nonfinite(tree) == jdbg.first_nonfinite(tree)
    tt = {"b": torch.from_numpy(b), "a": torch.from_numpy(a)}
    assert tdbg.first_nonfinite(tt) == jdbg.first_nonfinite(
        {"b": jnp.asarray(b), "a": jnp.asarray(a)})
    assert tdbg.first_nonfinite({"a": a}) is None
    jdbg.dump_blocks(b, n=3, title="b")
    want = capsys.readouterr().out
    tdbg.dump_blocks(torch.from_numpy(b), n=3, title="b")
    assert capsys.readouterr().out == want

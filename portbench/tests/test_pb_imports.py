"""No module of JAX or of the JAX package in a run, compared by whole
top-level name, and nothing of the program in the reference."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402


def test_top_level_names_compared_whole():
    mods = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
            "psba_tpu", "psba_tpu.solvers.lm", "psba_tpu_torch",
            "psba_tpu_torch.solvers.lm", "jaxtyping", "numpy"]
    assert harness.forbidden_modules(mods) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "psba_tpu",
        "psba_tpu.solvers.lm"]


def imported_names(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for p in (ROOT / "portbench").rglob("*.py"):
        assert not imported_names(p) & set(harness.FORBIDDEN), p


def test_reference_imports_nothing_of_the_program():
    for p in (ROOT / "portbench" / "reference").rglob("*.py"):
        assert "psba_tpu_torch" not in imported_names(p), p
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.lm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('psba_tpu_torch', 'psba_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)" % str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_a_run_loads_no_jax():
    """A whole run of a tiny cell on the CPU, in a process of its own."""
    code = f"""
import sys, time, copy
sys.path.insert(0, {str(ROOT)!r})
from portbench import harness
spec = copy.deepcopy(harness.cell("ladybug138.lm"))
spec["config"].update(n_cams=8, n_pts=200, n_obs=800)
r = harness.run_cell("ladybug138.lm", 5, 0.2, False, time.perf_counter(),
                     device="cpu", spec=spec)
bad = harness.forbidden_modules()
print(r["correct"], bad)
sys.exit(0 if r["correct"] and not bad else 1)
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr

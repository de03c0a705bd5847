"""A whole run of each cell on the card, untraced and traced (marked
`gpu`; skips where torch sees no CUDA device):

    python -m pytest portbench/tests/test_pb_card.py -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct(card, workload, trace):
    r = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", workload,
         "--seed", "6000000011", "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert list(line)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in BENCH[kind]
            if workload in m.get("workloads", [workload])}
    assert set(line["metrics"]) == want
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    if trace:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        for k, m in line["metrics"].items():
            if k.startswith("kernels_roofline"):
                assert 0 < m["value"] <= 100.0

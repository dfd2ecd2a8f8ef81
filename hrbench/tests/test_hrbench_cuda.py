"""On the card: one short run of each cell, untraced and traced, prints a
well-formed last line. Run there with

    python3 -m pytest -m cuda hrbench/tests/test_hrbench_cuda.py -q
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hrbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark()


@pytest.mark.cuda
@pytest.mark.parametrize("traced", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_short_run_prints_a_result_line(cell, traced):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    proc = subprocess.run(
        [sys.executable, "-m", "hrbench.run", "--workload", cell, "--seed", str(2**31 + 11),
         "--seconds", "2", "--trace", str(traced)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    want = {m["name"] for m in harness.cell_metrics(BENCH, cell, bool(traced))}
    assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] > 0
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] > 0
    assert dev["kind"] == torch.cuda.get_device_name(0)
    if traced:
        assert 0 < dev["busy_s"] <= dev["window_s"]
        assert 0 < line["metrics"]["kernel.roofline"]["value"] <= 100
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    tail = proc.stderr.strip().splitlines()[-len(line["checks"]):]
    assert all(t.startswith("check ") for t in tail)

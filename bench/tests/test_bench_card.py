"""On the card: a run of each cell prints the contract's result line, and
the control fails at the cell's own size.  Marked ``cuda``; run from the
repo's root with ``python -m pytest -m cuda bench/tests``."""
import json
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

import control
from harness import check, core

WORKLOADS = [w["name"] for w in core.load_json(ROOT / "BENCHMARK.json")
             ["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_traced_run_prints_the_result_line(cuda_card, workload):
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", workload, "--seed",
         str(2**31 + 99), "--seconds", "2", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    want = {m["name"] for m in core.cell_metrics(
        core.load_json(ROOT / "BENCHMARK.json"), workload, True)}
    assert set(res["metrics"]) == want
    for name, m in res["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 100, name
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails_at_the_cells_size(cuda_card, workload):
    got = control.readings(workload, 2**31 + 98, torch.bfloat16)
    lim = check.load_limits(ROOT / "bench" / "limits" / f"{workload}.json")
    assert check.verdict(got["program"], lim), got
    assert not check.verdict(got["control"], lim), got

"""The harness finds every part of a cell by name, takes a new cell from
added files alone, runs each cell on the CPU at a tiny size, and refuses
to measure without a card."""
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
from conftest import BENCH, ROOT, tiny

from harness import core


def manifest():
    return core.load_json(ROOT / "BENCHMARK.json")


WORKLOADS = [w["name"] for w in manifest()["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_harness_finds_each_part_of_a_cell_by_name(workload):
    m = manifest()
    files = core.cell_files(ROOT, m, workload)
    for key in ("config", "traffic", "limits"):
        assert files[key].is_file(), files[key]
    cfg = core.load_json(files["config"])
    assert cfg["name"] == files["cell"]["config"]
    assert {c["name"] for c in m["configs"]} >= {cfg["name"]}
    for traced in (False, True):
        for metric in core.cell_metrics(m, workload, traced):
            assert callable(core.load_reader(ROOT, metric["name"]))


def test_every_configuration_file_is_named_in_the_manifest():
    m = manifest()
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert core.load_json(ROOT / c["file"])["name"] == c["name"]
        assert core.load_json(ROOT / c["file"])["reduced"] == c["reduced"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_runs_correct_on_the_cpu(workload):
    out = core.run_cell(workload, 2**31 + 11, 0.3, False,
                        t_start_ns=time.perf_counter_ns(), device="cpu",
                        overrides=tiny(workload))
    res = out["result"]
    assert res["correct"] is True, out
    assert res["failed"] == 0 and res["attempted"] >= 2
    want = {x["name"] for x in core.cell_metrics(manifest(), workload,
                                                 False)}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert res["checks"]["cycles_mismatch"]["value"] == 0


def copy_of_the_benchmark(tmp_path):
    """A copy of the benchmark beside a link to ``src``, and the bytes of
    each of its files."""
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    os.symlink(ROOT / "src", tmp_path / "src")
    return {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
            if p.is_file()}


def add_cell(tmp_path, m, config, mix_name, **keys):
    """Add a configuration (``vampire-ddr3l``'s, with ``keys``), a tiny
    mix and the cell of both, as new files and manifest entries."""
    cfg = dict(core.load_json(BENCH / "configs" / "vampire-ddr3l.json"),
               name=config, **keys)
    (tmp_path / f"bench/configs/{config}.json").write_text(json.dumps(cfg))
    mix = core.load_json(BENCH / "traffic" / "batch-long.json")
    mix.update(requests_per_trace=20, traces_per_call=5, padded_len=192,
               device_batches=3)
    (tmp_path / f"bench/traffic/{mix_name}.json").write_text(json.dumps(mix))
    cell = f"{config}.{mix_name}"
    (tmp_path / f"bench/limits/{cell}.json").write_bytes(
        (BENCH / "limits" / "vampire-ddr3l.batch-long.json").read_bytes())
    m["configs"].append({"name": config, "source": "x",
                         "file": f"bench/configs/{config}.json",
                         "reduced": [], "why": "a test's configuration"})
    m["workloads"].append({"name": cell, "config": config,
                           "traffic": mix_name, "chips": 1,
                           "why": "a test's cell"})
    for metric in m["end_to_end"]:
        if metric["name"] in ("scored_cmds_per_s", "call_p95_ms"):
            metric["workloads"].append(cell)
    return cell


def test_a_new_cell_is_taken_from_added_files_alone(tmp_path):
    """A copy of the benchmark gains a configuration whose model and
    reference are new, an entry for that model, a reference, a mix, a
    cell's limits and a metric, as new files and manifest entries; no
    file of the copy is edited, and the new cell runs through the new
    entry and the new reference, with its new metric."""
    before = copy_of_the_benchmark(tmp_path)
    m = manifest()
    cell = add_cell(tmp_path, m, "vampire-ab", "tiny-mix",
                    model="vampire-two", reference="vampire-two",
                    params={**core.load_json(
                        BENCH / "configs" / "vampire-ddr3l.json")["params"],
                        "vendors": [0, 1]})
    entry = (BENCH / "entries" / "vampire.estimate.py").read_text()
    (tmp_path / "bench/entries/vampire-two.estimate.py").write_text(
        entry + "\n\nENTERED = []\n_enter = Program.enter\n"
        "Program.enter = lambda self, b: ENTERED.append(1) or "
        "_enter(self, b)\n")
    (tmp_path / "bench/reference/vampire-two.py").write_text(
        "from reference.vampire import EXACT, FLOAT\n"
        "from reference import vampire\n"
        "CALLED = []\n\n\n"
        "def reports(*args, **kw):\n"
        "    CALLED.append(1)\n"
        "    return vampire.reports(*args, **kw)\n")
    (tmp_path / "bench/metrics/calls_done.py").write_text(
        "def read(run):\n    return len(run.ok_calls)\n")
    m["end_to_end"].append({"name": "calls_done", "unit": "calls",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    out = core.run_cell(cell, 3, 0.2, False,
                        t_start_ns=time.perf_counter_ns(), device="cpu",
                        root=tmp_path)
    res = out["result"]
    assert res["correct"] is True, out
    assert res["metrics"]["calls_done"]["value"] == res["attempted"]
    assert {"scored_cmds_per_s", "call_p95_ms", "setup_s"} <= set(
        res["metrics"])
    assert sys.modules["bench_entries_vampire_two_estimate"].ENTERED
    assert sys.modules["bench_reference_vampire_two"].CALLED == [1]
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("key", ["model", "reference"])
def test_a_name_with_no_file_is_refused(tmp_path, key):
    """A configuration whose model has no entry, or whose reference has no
    file, stops the run before anything is measured: it never falls back
    to another model's path."""
    copy_of_the_benchmark(tmp_path)
    m = manifest()
    cell = add_cell(tmp_path, m, "drampower-ddr3l", "tiny-mix",
                    **{key: "drampower"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    folder = {"model": "entries", "reference": "reference"}[key]
    with pytest.raises(FileNotFoundError, match=f"bench/{folder}/"):
        core.run_cell(cell, 3, 0.2, False,
                      t_start_ns=time.perf_counter_ns(), device="cpu",
                      root=tmp_path)


def test_a_module_loaded_after_the_window_stops_the_result(tmp_path):
    """A metric reader that loads JAX (here a stand-in module under its
    name) after the window, where no look at the sources sees it: the
    run prints no result line and exits non-zero."""
    copy_of_the_benchmark(tmp_path)
    m = manifest()
    cell = add_cell(tmp_path, m, "vampire-ab", "tiny-mix")
    (tmp_path / "bench/metrics/loads_jax.py").write_text(
        "import sys\nimport types\n\n\n"
        "def read(run):\n"
        "    sys.modules['jax'] = types.ModuleType('jax')\n"
        "    return 1.0\n")
    m["end_to_end"].append({"name": "loads_jax", "unit": "x",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    code = f"""
import sys, time
sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]
import run
from harness import core
out = core.run_cell({cell!r}, 3, 0.2, False,
                    t_start_ns=time.perf_counter_ns(), device="cpu",
                    root={str(tmp_path)!r})
assert out["result"]["correct"], out
sys.exit(run.report(out))
"""
    got = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 3, got.stderr[-3000:]
    assert got.stdout == ""
    assert "['jax']" in got.stderr


def run_cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload",
         "vampire-ddr3l.batch-long", "--seed", "1", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_without_a_card_the_run_exits_nonzero_before_measuring():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = run_cli(ROOT)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA" in out.stderr


def test_a_directory_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = run_cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_the_manifest_keeps_to_the_contract():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["bench"] and m["command"][1] == "bench/run.py"
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    e2e = {x["name"] for x in m["end_to_end"]}
    assert "setup_s" in e2e
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        assert set(x["workloads"]) <= set(WORKLOADS)
    for w in m["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(m)) < 64 * 1024

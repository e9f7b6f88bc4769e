"""One run of one cell: set-up, the measured window, the check against
the reference, and the result line.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration (``configs/<config>.json``)
and its mix (``traffic/<mix>.json``); the configuration's ``model`` and
the mix's ``entry`` name the code that calls the program
(``entries/<model>.<entry>.py``, a ``Program``); the configuration's
``reference`` names the plain reference (``reference/<reference>.py``);
the cell's limits are ``limits/<cell>.json``; each metric it reports is
read by ``metrics/<metric>.py``, whose ``read(run)`` returns the value
(or a dict with ``value`` and further keys), or None where it finds
nothing to read.  A name with no file is an error.  A new cell, mix,
configuration, entry, reference or metric is a new file and a new
entry, and no edit here.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BANNED = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Call:
    batch: int
    t0: int          # perf_counter_ns when the call started
    t_ret: int       # when the entry point returned
    t_ready: int     # when its result was ready to read
    ok: bool


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""
    cell: dict
    cfg: dict
    mix: dict
    setup_s: float
    calls: list
    window_s: float
    works: list                 # counts.Work of each device batch
    peaks: dict | None          # the card's published peaks
    power_limit: str | None
    trace: object = None        # profile.Trace in a traced run

    @property
    def ok_calls(self) -> list:
        return [c for c in self.calls if c.ok]


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_files(root: pathlib.Path, manifest: dict, workload: str) -> dict:
    """The files a cell is made of, found by the names in the manifest."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    bench = root / "bench"
    return dict(cell=cell,
                config=bench / "configs" / f"{cell['config']}.json",
                traffic=bench / "traffic" / f"{cell['traffic']}.json",
                limits=bench / "limits" / f"{workload}.json")


def cell_metrics(manifest: dict, workload: str, traced: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with tracing its per-layer ones."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group
            if "workloads" not in m or workload in m["workloads"]]


def load_module(root: pathlib.Path, folder: str, name: str, what: str):
    """The module ``bench/<folder>/<name>.py``; ``what`` says, in an error,
    which key of which file named it."""
    path = pathlib.Path(root) / "bench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{what} names {name!r}, and there is no "
                                f"bench/{folder}/{name}.py")
    tag = "".join(ch if ch.isalnum() else "_" for ch in name)
    spec = importlib.util.spec_from_file_location(
        f"bench_{folder}_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_reader(root: pathlib.Path, name: str):
    """``bench/metrics/<name>.py``'s ``read``."""
    return load_module(root, "metrics", name, "BENCHMARK.json").read


def load_entry(root: pathlib.Path, cfg: dict, mix: dict):
    """The ``Program`` class of ``bench/entries/<model>.<entry>.py``."""
    return load_module(root, "entries", f"{cfg['model']}.{mix['entry']}",
                       f"the configuration {cfg['name']!r} (model) with a "
                       f"mix (entry)").Program


def load_reference(root: pathlib.Path, cfg: dict):
    """``bench/reference/<reference>.py``: ``reports``, ``EXACT``,
    ``FLOAT``."""
    return load_module(root, "reference", cfg["reference"],
                       f"the configuration {cfg['name']!r} (reference)")


def set_cache_dirs(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its kernels into ``<checkout>/build/repro_torch``)."""
    build = root / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    os.environ["USE_FLAX"] = "0"


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    text = out.stdout.strip()
    return text.splitlines()[0] if out.returncode == 0 and text else None


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def banned_modules() -> list:
    """The top-level names of loaded modules that no run may hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def run_cell(workload: str, seed: int, seconds: float, traced: bool, *,
             t_start_ns: int, device: str = "cuda", root=ROOT,
             overrides: dict | None = None, wrap=None) -> dict:
    """One run -> ``{"result": the result line's object, "checks": the
    compared numbers with their limits, "errors": the first failed
    calls' messages, "run": the :class:`Run` the metrics were read
    from}``.  ``overrides`` replaces keys of the configuration
    (``"config"``) and the mix (``"traffic"``); ``wrap(program)`` may
    replace the program's ``call`` (the tests' faults)."""
    import torch

    from harness import check, peaks, profile, program
    from harness import traffic as tf

    root = pathlib.Path(root)
    manifest = load_json(root / "BENCHMARK.json")
    files = cell_files(root, manifest, workload)
    cell = files["cell"]
    cfg = load_json(files["config"])
    mix = load_json(files["traffic"])
    if overrides:
        cfg.update(overrides.get("config", {}))
        mix.update(overrides.get("traffic", {}))
    limits = check.load_limits(files["limits"])
    Program = load_entry(root, cfg, mix)
    reference = load_reference(root, cfg)
    on_card = torch.device(device).type == "cuda"

    t = time.perf_counter()
    inputs = tf.make_inputs(cfg, mix, seed)
    log(f"[setup] inputs from the seed: {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    prog = Program(root, cfg, mix, inputs, device)
    log(f"[setup] program and batches on {device}: "
        f"{time.perf_counter() - t:.3f} s")
    if wrap is not None:
        wrap(prog)
    n_cells = (int(cfg["dram"]["banks"]) * int(cfg["dram"]["row_bands"])
               if mix["mode"] == "surface" else 1)
    works = [tf.work(inputs, o, prog.n_sets, n_cells) for o in inputs.orders]
    nb = len(prog.batches)
    for r in range(2):                    # warm every shape the cell uses
        t = time.perf_counter()
        for b in range(nb):
            prog.call(b)
        log(f"[setup] warm round {r}: {time.perf_counter() - t:.3f} s")
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    limit_w = power_limit() if on_card else None
    prof = None
    if traced and on_card:
        profile.warm_profiler()
        prof = profile.Profiler()
    program.sync(device)

    calls, kept, errors = [], {}, []
    if prof is not None:
        prof.start()
    offset = profile.clock_offset_ns()
    t_w0 = time.perf_counter_ns()
    setup_s = (t_w0 - t_start_ns) / 1e9
    deadline = t_w0 + int(seconds * 1e9)
    i = 0
    while True:
        b = i % nb
        t0 = time.perf_counter_ns()
        try:
            out, t_ret = prog.call(b)
            ok = True
        except Exception as exc:          # a failed call counts, and runs on
            out, t_ret, ok = None, time.perf_counter_ns(), False
            errors.append(f"call {i}: {type(exc).__name__}: {exc}")
        t1 = time.perf_counter_ns()
        calls.append(Call(b, t0, t_ret, t1, ok))
        if ok:
            kept[b] = out
        i += 1
        if t1 >= deadline and i >= nb:     # every device batch answered
            break
    window_s = (calls[-1].t_ready - t_w0) / 1e9
    if prof is not None:
        prof.stop()

    memory_peak = torch.cuda.max_memory_allocated(0) if on_card else 0

    trace = None
    if prof is not None:
        names, s, e = prof.events()
        trace = profile.Trace(names, s, e, profile.host_spans(calls, offset))
        del prof

    # the check, once the window has closed and the program's state is gone
    outs = {b: prog.leaves(o) for b, o in kept.items()}
    del kept
    prog.free()
    t = time.perf_counter()
    ref = reference.reports(root, cfg, mix, inputs, device)
    numbers = check.compare(outs, inputs.orders, ref, reference.EXACT,
                            reference.FLOAT)
    log(f"[check] reference and comparison: {time.perf_counter() - t:.3f} s")
    failed = sum(not c.ok for c in calls)
    missing = [b for b in range(nb) if b not in outs]
    correct = (check.verdict(numbers, limits) and failed == 0
               and not missing)

    run = Run(cell, cfg, mix, setup_s, calls, window_s, works,
              peaks.peaks_for(kind), limit_w, trace)
    metrics = {}
    for m in cell_metrics(manifest, workload, traced):
        got = load_reader(root, m["name"])(run)
        if got is None:
            continue
        entry = dict(got) if isinstance(got, dict) else {"value": got}
        entry["value"] = float(entry["value"])
        entry["unit"] = m["unit"]
        metrics[m["name"]] = entry

    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": int(cell["chips"]), "memory_peak_bytes": memory_peak,
           "power_limit": limit_w}
    result = {"correct": bool(correct), "attempted": len(calls),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace is not None:
        t_first = calls[0].t0 + offset
        t_last = calls[-1].t_ready + offset
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = window_s
        result["breakdown"] = {
            "device_ops": profile.top_ops(trace),
            "idle_gaps": profile.idle_gaps(trace, (t_first, t_last))}
    checks = {k: {"value": numbers[k], "limit": limits[k]}
              for k in check.NUMBERS}
    result["checks"] = checks
    return {"result": result, "checks": checks, "errors": errors[:5],
            "run": run}

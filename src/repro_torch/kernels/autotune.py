"""Launch-geometry autotuner for the charge kernels.

A port of ``repro.kernels.autotune``.  The reference tunes the Pallas
kernels' command-axis block (``block_n``) and grid order; the CUDA charge
kernels (``csrc/charge.cuh``) take their geometry from
``kernels.common.charge_geometry``, whose two runtime knobs are tuned
here instead:

* ``blocks_per_sm`` in (1, 2, 4) — how many blocks per SM the grid is
  sized for, which sets how many blocks (one cluster) each trace gets;
* ``max_cluster`` in (1, 2, 4, 8) — the most blocks a trace's cluster may
  have (8 is the portable cluster size).

The defaults are ``common.BLOCKS_PER_SM`` and ``common.MAX_CLUSTER``.
A family is a source's mean or surface kernels (``vampire_energy``,
``vampire_energy_surface``, ``baseline_energy``,
``baseline_energy_surface``): the surface kernels reduce into 64 cells
and are tuned apart from the mean ones.

* :func:`best_config` — the committed winner for ``(card, family, shape
  bucket)``, or the defaults when the table has no row.
  ``kernels.common.launch_charge`` consults it whenever the caller pins no
  ``config``; ``REPRO_AUTOTUNE=0`` turns the lookup off (the defaults,
  exactly).
* :func:`sweep` — time a family's launch over the candidate knobs at a
  set of shapes with CUDA events after a warm call, and return the
  winners.
* :func:`update_table` — merge winners into ``autotune_table.json``;
  ``python -m repro_torch.kernels.autotune`` sweeps the main path's
  shapes on the card it runs on and rewrites that card's rows.

The table is keyed by ``torch.cuda.get_device_name()``; the CPU has no
launch geometry and no rows.  Shapes bucket to powers of two, as the
serving ring's pad shapes do.
"""
from __future__ import annotations

import functools
import json
import os
import pathlib

import torch

from repro_torch.kernels.common import BLOCKS_PER_SM, MAX_CLUSTER

TABLE_PATH = pathlib.Path(__file__).with_name("autotune_table.json")

BLOCKS_PER_SM_CHOICES = (1, 2, 4)
CLUSTER_CHOICES = (1, 2, 4, 8)
FAMILIES = ("vampire_energy", "vampire_energy_surface", "baseline_energy",
            "baseline_energy_surface")
DEFAULT_CONFIG = {"blocks_per_sm": BLOCKS_PER_SM, "max_cluster": MAX_CLUSTER}
MARGIN = 0.05              # how much faster a candidate must be to win
SPIN_CYCLES = 200_000      # ~0.1 ms of device clock before a timed launch

#: the main path's charge-kernel shapes (traces, commands, vendors):
#: the estimation batch, the validation sweeps, a recalibration telemetry
#: slice, the campaign's IDD loops and its probes
MAIN_PATH_SHAPES = {
    "estimation": (64, 16384, 3),
    "validation": (23, 6128, 3),
    "slice": (120, 1030, 50),
    "idd": (12, 1536, 50),
    "probes": (348, 1030, 50),
}
#: the shapes each family runs at on the main path
_V3 = (MAIN_PATH_SHAPES["estimation"], MAIN_PATH_SHAPES["validation"])
FAMILY_SHAPES = {
    "vampire_energy": tuple(MAIN_PATH_SHAPES.values()),
    "vampire_energy_surface": _V3,
    "baseline_energy": _V3,
    "baseline_energy_surface": _V3,
}


def candidates() -> list[dict]:
    """Every (blocks_per_sm, max_cluster) pair, the default first."""
    out = [dict(DEFAULT_CONFIG)]
    for bps in BLOCKS_PER_SM_CHOICES:
        for mc in CLUSTER_CHOICES:
            cfg = {"blocks_per_sm": bps, "max_cluster": mc}
            if cfg != DEFAULT_CONFIG:
                out.append(cfg)
    return out


def shape_bucket(n_traces: int, n_cmds: int) -> str:
    """Power-of-two shape bucket, e.g. ``t32n4096`` — the rounding the
    serving ring applies to pad shapes, so one row covers every launch
    that lands in the bucket."""
    def up(v: int) -> int:
        return 1 << max(int(v) - 1, 0).bit_length()
    return f"t{up(n_traces)}n{up(n_cmds)}"


@functools.lru_cache(maxsize=1)
def _table() -> dict:
    try:
        with open(TABLE_PATH) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


@functools.lru_cache(maxsize=None)
def _lookup(device_key: str, family: str, bucket: str) -> tuple[int, int]:
    entry = _table().get(device_key, {}).get(family, {}).get(bucket, {})
    return (int(entry.get("blocks_per_sm", BLOCKS_PER_SM)),
            int(entry.get("max_cluster", MAX_CLUSTER)))


def lookups() -> int:
    """Distinct (card, family, bucket) lookups made so far (the
    dispatch audit counts them as per-shape launch state)."""
    return _lookup.cache_info().currsize


def reload_table() -> None:
    """Drop the cached table and lookups (tests, after ``update_table``)."""
    _table.cache_clear()
    _lookup.cache_clear()


def best_config(family: str, n_traces: int, n_cmds: int,
                device_key: str | None = None) -> dict:
    """The tuned ``{"blocks_per_sm", "max_cluster"}`` of this card
    (``device_key``, the current CUDA device's name by default), family
    and shape bucket, or :data:`DEFAULT_CONFIG` when the table has no row
    or ``REPRO_AUTOTUNE=0``."""
    if os.environ.get("REPRO_AUTOTUNE", "1") in ("0", "false", "False"):
        return dict(DEFAULT_CONFIG)
    if device_key is None:
        device_key = torch.cuda.get_device_name()
    bps, mc = _lookup(device_key, family, shape_bucket(n_traces, n_cmds))
    return {"blocks_per_sm": bps, "max_cluster": mc}


def choices(families=FAMILIES, device_key: str | None = None) -> dict:
    """The committed rows of a card (the current one by default) per
    family."""
    if device_key is None:
        device_key = torch.cuda.get_device_name()
    sub = _table().get(device_key, {})
    return {f: sub.get(f, {}) for f in families}


def event_us(fn, iters: int = 10) -> float:
    """Mean device µs of one ``fn()`` launch over ``iters`` windows, each
    between two CUDA events after a ~0.1 ms device-side spin, so the
    wrapper's host time is enqueued ahead and does not show up as device
    time (the inputs stay in L2 from one window to the next)."""
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total * 1e3 / iters


def sweep(family: str, run_fn, shapes, repeats: int = 3,
          timer=None) -> dict:
    """Time ``run_fn(n_traces, n_cmds, n_vendors, config)`` for every
    candidate ``config`` at each ``(n_traces, n_cmds, n_vendors)`` shape:
    one warm call each, then ``repeats`` rounds over all candidates, and
    the least reading of ``timer`` per candidate (:func:`event_us` by
    default; it takes a no-argument callable and returns µs; rounds keep
    a clock that is still rising from hurting the first candidates).  A candidate replaces the default only when it is
    ``MARGIN`` faster.  Returns ``{bucket: {"blocks_per_sm",
    "max_cluster", "n_vendors", "us", "default_us", "candidates_us"}}``."""
    timer = event_us if timer is None else timer
    out = {}
    for n_traces, n_cmds, n_vendors in shapes:
        calls = {}
        for cfg in candidates():
            def call(cfg=cfg):
                return run_fn(n_traces, n_cmds, n_vendors, cfg)
            call()                                          # warm
            calls[(cfg["blocks_per_sm"], cfg["max_cluster"])] = call
        timings = {key: float("inf") for key in calls}
        for _ in range(repeats):
            for key, call in calls.items():
                timings[key] = min(timings[key], timer(call))
        default = (DEFAULT_CONFIG["blocks_per_sm"],
                   DEFAULT_CONFIG["max_cluster"])
        default_us = timings[default]
        win = min(timings, key=timings.get)
        if timings[win] > default_us * (1 - MARGIN):
            win = default
        out[shape_bucket(n_traces, n_cmds)] = {
            "blocks_per_sm": win[0], "max_cluster": win[1],
            "n_vendors": int(n_vendors), "us": round(timings[win], 3),
            "default_us": round(default_us, 3),
            "candidates_us": {f"bps{b}/c{c}": round(v, 3)
                              for (b, c), v in timings.items()},
        }
    return out


def update_table(family: str, entries: dict, path=TABLE_PATH,
                 device_key: str | None = None) -> dict:
    """Merge sweep winners for a card (the current one by default) into
    the table at ``path`` and rewrite it (each row with the V it was tuned
    at, its µs and the default's; the per-candidate timings are left
    out).  Returns the merged table."""
    if device_key is None:
        device_key = torch.cuda.get_device_name()
    try:
        with open(path) as f:
            table = json.load(f)
    except (OSError, ValueError):
        table = {}
    rows = table.setdefault(device_key, {}).setdefault(family, {})
    for bucket, entry in entries.items():
        rows[bucket] = {k: entry[k] for k in
                        ("blocks_per_sm", "max_cluster", "n_vendors", "us",
                         "default_us")}
    with open(path, "w") as f:
        json.dump(table, f, indent=2, sort_keys=True)
        f.write("\n")
    reload_table()
    return table


# ---------------------------------------------------------------------------
# The runners: each family's wrapper on inputs made once per shape
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=16)
def launch_inputs(source: str, n_traces: int, n_cmds: int, n_vendors: int,
                  device: str = "cuda") -> tuple:
    """The wrapper's arguments of a family's source (``vampire_energy``
    or ``baseline_energy``) at one shape: ``n_traces``
    validation sweeps (8 reads a row) cut to ``n_cmds`` commands, and
    ``n_vendors`` parameter sets (the rig vendors' true params, or a
    synthetic fleet past three) or datasheet rows."""
    from repro_torch.core import device_sim, idd_loops
    from repro_torch.core import params as P
    from repro_torch.core.baselines_power import BASELINE_IDD_KEYS
    from repro_torch.core.dram import ACT, CommandTrace
    from repro_torch.core.energy_model import structural_state
    from repro_torch.core.estimate_batch import TraceBatch
    from repro_torch.core.fleet import stack_params
    from repro_torch.kernels.vampire_energy import ops as vops

    reps = n_cmds // 10 + 1
    tb = TraceBatch.from_traces(
        [idd_loops.validation_sweep(8, reps=reps)] * n_traces)
    trace = CommandTrace(*(x[:, :n_cmds].contiguous().to(device)
                           for x in tb.trace))
    weight = tb.weight[:, :n_cmds].contiguous().to(device)
    if source == "vampire_energy":
        if n_vendors <= 3:
            stacked = stack_params([device_sim.true_vendor_params(v)
                                    for v in range(n_vendors)]).to(device)
        else:
            _, stacked = device_sim.synth_fleet_params(n_vendors,
                                                       device=device)
        planes = vops.charge_planes(trace, weight)
        return (*planes, vops.pack_param_blocks(stacked))
    if source == "baseline_energy":
        table = torch.tensor(
            [[float(P.MEASURED_IDD.get(k, (100.0,) * 3)[v % 3])
              for k in BASELINE_IDD_KEYS] for v in range(n_vendors)],
            dtype=torch.float32, device=device)
        st = structural_state(trace)
        any_act = (trace.cmd == ACT).any(dim=-1).to(torch.float32)
        return (trace.cmd, trace.bank, trace.row, trace.dt,
                vops.pack_state(st), weight, any_act, table)
    raise ValueError(f"unknown source {source!r}; expected "
                     f"'vampire_energy' or 'baseline_energy'")


def run_charge(family: str, n_traces: int, n_cmds: int, n_vendors: int,
               config: dict | None, *, device: str = "cuda") -> torch.Tensor:
    """One launch of ``family``'s charge kernel (the Micron kernels for
    the baselines) at a shape, with the geometry ``config`` (None: the
    autotuner's choice)."""
    from repro_torch.kernels.baseline_energy.baseline_energy import WRAPPERS
    from repro_torch.kernels.vampire_energy import vampire_energy as ve
    source, surface = family.removesuffix("_surface"), \
        family.endswith("_surface")
    args = launch_inputs(source, n_traces, n_cmds, n_vendors, device)
    if source == "vampire_energy":
        fn = ve.vampire_charge_surface if surface else ve.vampire_charge
    else:
        fn = WRAPPERS["micron", surface]
    return fn(*args, config=config)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kernels.autotune",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default=None,
                    help="comma-separated TRACESxCOMMANDSxVENDORS shapes "
                         "(default: each family's main-path shapes)")
    ap.add_argument("--families", default=",".join(FAMILIES))
    ap.add_argument("--table", default=str(TABLE_PATH),
                    help="table to rewrite")
    ap.add_argument("--dry-run", action="store_true",
                    help="print winners without rewriting the table")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the autotuner times the kernels on a CUDA device")
    device_key = torch.cuda.get_device_name()
    for family in args.families.split(","):
        shapes = (FAMILY_SHAPES[family] if args.shapes is None else
                  [tuple(int(v) for v in s.split("x"))
                   for s in args.shapes.split(",")])
        winners = sweep(family, functools.partial(run_charge, family),
                        shapes)
        for bucket, e in winners.items():
            print(f"{device_key}/{family}/{bucket} V={e['n_vendors']}: "
                  f"blocks_per_sm={e['blocks_per_sm']} "
                  f"max_cluster={e['max_cluster']} us={e['us']} "
                  f"default_us={e['default_us']} "
                  f"candidates={e['candidates_us']}", flush=True)
        if not args.dry_run:
            update_table(family, winners, args.table, device_key)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())

"""The one traffic generator: it reads a mix's data file
(``traffic/<mix>.json``) and makes, from the run's seed, the trace pool
and the device batches a run's calls take in turn.

A mix's keys:

* ``entry``: the call, with the configuration's ``model`` the name of
  ``entries/<model>.<entry>.py`` (``"estimate"``: ``Vampire.estimate``;
  ``"fleet_map"``: ``fleet.fleet_surface_energy``);
* ``mode``: ``"mean"`` or ``"surface"``;
* ``requests_per_trace``, ``pool_per_app``: the pool holds
  ``pool_per_app`` traces of each of the 23 ``SPEC_APPS``, each of that
  many requests;
* ``traces_per_call``, ``padded_len``: a call's batch is ``(traces,
  padded_len)`` command slots, every trace NOP/dt=0-padded to the length;
* ``device_batches``: distinct batches built before the window, taken in
  turn;
* ``draw``: ``"balanced"`` (each batch is the pool in seeded orders,
  repeated until the batch is full, so every seed scores the same mix of
  traces) or ``"permutation"`` (each batch one seeded ordering of the
  whole pool);
* ``result``: ``"host"`` (the report is copied to the host) or
  ``"device"`` (the call ends in a synchronise);
* ``module_chunk`` (``fleet_map``): modules a charge launch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from harness import tracegen

FIELDS = ("cmd", "bank", "row", "col", "data", "dt")


@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed, on the host."""
    pool: dict            # field -> (P, N[, W]) int32; "weight" (P, N) f32
    lengths: np.ndarray   # (P,) real commands of each pool trace
    names: list           # (P,) app of each pool trace
    orders: list          # per device batch, (T,) pool rows
    fleet: dict | None    # the synthetic fleet's leaves, or None


def entropy(seed: int, *words: int) -> tuple:
    """Seed-sequence words of the run's seed (any whole number; a
    negative one is taken modulo 2**64) and of ``words``."""
    return (int(seed) % (1 << 64),) + tuple(int(w) for w in words)


def make_pool(mix: dict, dram: tracegen.Dram, seed: int):
    """The pool's traces, padded to ``padded_len`` -> (fields, lengths,
    names).  Raises ``ValueError`` if a trace is longer."""
    n = int(mix["padded_len"])
    n_req = int(mix["requests_per_trace"])
    traces, names = [], []
    for k in range(int(mix["pool_per_app"])):
        for app in tracegen.SPEC_APPS:
            traces.append(tracegen.app_trace(
                app, n_req, dram, entropy=entropy(seed, app.seed, k)))
            names.append(app.name)
    p = len(traces)
    pool = {f: np.zeros((p, n), np.int32) for f in FIELDS if f != "data"}
    pool["data"] = np.zeros((p, n, dram.line_words), np.int32)
    lengths = np.zeros(p, np.int64)
    for i, tr in enumerate(traces):
        m = tr["cmd"].shape[0]
        if m > n:
            raise ValueError(f"trace {i} ({names[i]}) has {m} commands, "
                             f"more than padded_len {n}")
        lengths[i] = m
        for f in FIELDS:
            pool[f][i, :m] = tr[f]
    pool["weight"] = (np.arange(n)[None, :] < lengths[:, None]).astype(
        np.float32)
    return pool, lengths, names


def batch_orders(mix: dict, n_pool: int, seed: int) -> list:
    """Per device batch, the pool rows of its traces."""
    t = int(mix["traces_per_call"])
    orders = []
    for b in range(int(mix["device_batches"])):
        rng = np.random.default_rng(np.random.SeedSequence(
            list(entropy(seed, 1 << 20, b))))
        if mix["draw"] == "permutation":
            if t != n_pool:
                raise ValueError("a permutation draw takes the whole pool "
                                 f"({n_pool}), not {t} traces")
            orders.append(rng.permutation(n_pool))
        elif mix["draw"] == "balanced":
            reps = -(-t // n_pool)
            orders.append(np.concatenate(
                [rng.permutation(n_pool) for _ in range(reps)])[:t])
        else:
            raise ValueError(f"unknown draw {mix['draw']!r}")
    return orders


def make_inputs(cfg: dict, mix: dict, seed: int) -> Inputs:
    from harness import fleet
    dram = tracegen.Dram.from_config(cfg)
    pool, lengths, names = make_pool(mix, dram, seed)
    orders = batch_orders(mix, len(names), seed)
    leaves = None
    params = cfg["params"]
    if params["kind"] == "synthetic_fleet":
        d = cfg["dram"]
        leaves = fleet.synth_fleet(int(params["n_modules"]),
                                   entropy(seed, 1 << 21), dram.timing,
                                   int(d["banks"]), int(d["row_bands"]))
    return Inputs(pool, lengths, names, orders, leaves)


def work(inputs: Inputs, order: np.ndarray, n_sets: int,
         cells: int) -> "counts.Work":
    """The counts' view of one batch."""
    from harness import counts
    cmd = inputs.pool["cmd"][order]
    w = inputs.pool["weight"][order] != 0
    rw = int((((cmd == tracegen.RD) | (cmd == tracegen.WR)) & w).sum())
    return counts.Work(traces=len(order), slots=int(cmd.size),
                       real=int(inputs.lengths[order].sum()), rw=rw,
                       sets=n_sets, cells=cells)

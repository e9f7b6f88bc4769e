"""What decides ``correct``: the program's reports against the plain
reference, recomputed from the benchmark's own inputs after the window
has closed.

The reference is ``reference/<reference>.py``, found by the
configuration's ``reference`` key.  It gives ``reports(root, cfg, mix,
inputs, device, dtype)``, the report of every pool trace and parameter
set, and names the leaves it compares: ``EXACT`` and ``FLOAT``.  Each
trace's report does not depend on the batch around it, so every kept
output, the last of each device batch, is compared in full, row by row,
with the reference's rows of the traces its batch drew: every parameter
set, and every module of a fleet map.

Two numbers are compared, each against its limit in
``limits/<cell>.json``:

* ``cycles_mismatch``: entries of the ``EXACT`` leaves (the cycles)
  that differ (exact, 0);
* ``energy_rel_err``: the widest relative gap over the ``FLOAT`` leaves
  (charge, average current, energy and time), against the reference's
  value; an entry the reference gives 0 must be 0 (else the gap is
  infinite).
"""
from __future__ import annotations

import json

import numpy as np
import torch

NUMBERS = ("cycles_mismatch", "energy_rel_err")


def compare(kept: dict, orders: list, ref: dict, exact, floats) -> dict:
    """The compared numbers over every kept output (``kept``: device batch
    -> report leaves), each row against the reference's row of its
    trace, on the output's device."""
    mismatch = 0
    worst = 0.0
    for b, out in kept.items():
        for k in tuple(exact) + tuple(floats):
            got = out[k]
            order = torch.as_tensor(np.asarray(orders[b], np.int64),
                                    device=got.device)
            want = ref[k].to(got.device).index_select(0, order)
            if tuple(got.shape) != tuple(want.shape):
                return {"cycles_mismatch": float("inf"),
                        "energy_rel_err": float("inf")}
            if k in exact:
                mismatch += int((got.long() != want.long()).sum())
                continue
            g = got.double()
            w = want.double()
            gap = (g - w).abs()
            rel = torch.where(w != 0, gap / w.abs().clamp(min=1e-300),
                              torch.where(gap == 0, 0.0, float("inf")))
            rel = torch.where(torch.isnan(rel), float("inf"), rel)
            worst = max(worst, float(rel.max()))
    return {"cycles_mismatch": mismatch, "energy_rel_err": worst}


def load_limits(path) -> dict:
    with open(path) as f:
        spec = json.load(f)
    return {name: float(spec[name]["limit"]) for name in NUMBERS}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[k] <= limits[k] for k in NUMBERS)

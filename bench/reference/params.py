"""The reference's parameter sets, worked out from the benchmark's own
inputs: the fitted model file, or the synthetic fleet's leaves.

``from_fit_file`` is a frozen copy of ``repro_torch/convert.py``'s
``params_from_fitted`` (origin: commit 3b119a0): the stored fitted
quantities of every vendor become the estimator's leaves, with the
rig-visible I/O driver currents of ``repro_torch/core/params.py``, no
quadratic term, and the fast power-down current standing in for any
low-power state the file lacks.  The leaves are rounded to float32, the
precision the configuration states, before the reference widens them.
"""
from __future__ import annotations

import numpy as np
import torch

IO_DRIVER_MA_PER_ONE_READ = 0.40
IO_DRIVER_MA_PER_ZERO_WRITE = 0.39


def from_fit_file(path: str, vendors, n_banks: int = 8,
                  n_bands: int = 8) -> dict:
    """float32 numpy leaves of the vendors ``vendors`` of a schema-v2
    VAMPIRE file, in the order given."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {name: np.asarray(z[name]) for name in z.files
                  if not name.startswith("raw/") and name != "__manifest__"}
    ids = [int(v) for v in arrays["vendor_ids"]]
    rows = [ids.index(int(v)) for v in vendors]
    nv = len(ids)
    i_pd = np.asarray(arrays["i_pd"], np.float64)
    leaves = {name: np.asarray(arrays[name], np.float64) for name in
              ("datadep", "i2n", "bank_open_delta", "bank_read_factor",
               "bank_write_factor", "q_actpre", "row_ones_slope", "q_ref")}
    leaves["i_pd"] = i_pd
    leaves["io_read_ma_per_one"] = np.full(nv, IO_DRIVER_MA_PER_ONE_READ)
    leaves["io_write_ma_per_zero"] = np.full(nv, IO_DRIVER_MA_PER_ZERO_WRITE)
    leaves["ones_quad"] = np.zeros(nv)
    leaves["act_surface"] = (np.asarray(arrays["act_surface"], np.float64)
                             if "act_surface" in arrays
                             else np.ones((nv, n_banks, n_bands)))
    for name in ("i_pd_slow", "i_actpd", "i_sr"):
        leaves[name] = (np.asarray(arrays[name], np.float64)
                        if name in arrays else i_pd)
    return {name: np.ascontiguousarray(x.astype(np.float32)[rows])
            for name, x in leaves.items()}


def on_device(leaves: dict, device, rows=None) -> dict:
    """The leaves (optionally only the sets ``rows``) as float64 tensors
    on ``device``."""
    out = {}
    for name, x in leaves.items():
        x = np.asarray(x)
        if rows is not None:
            x = x[rows]
        out[name] = torch.from_numpy(x.astype(np.float64)).to(device)
    return out

"""Cache-line data encodings (paper Section 10).

Four encodings applied to line data before it is written to DRAM:

* ``baseline``  — identity.
* ``bdi``       — Base-Delta-Immediate compression [127]: the encoded line is
  the packed (base, deltas) representation padded with zeros; incompressible
  lines pass through unchanged.
* ``optimized`` — per-application byte-frequency LUT: the most frequent byte
  values get the codes with the fewest ones (code assignment sorted by
  (popcount, value)).  Lowers read power (read current grows with ones).
* ``owi``       — Optimized-with-Write-Inversion: stored cells hold the
  Optimized encoding; the bus carries its bitwise complement on *writes*
  (write current falls with ones), the plain encoding on reads.

The table and the BDI packing are host (numpy) code, as in the reference:
``bdi_encode_lines`` is the independent packing oracle the BDI kernel is
held against.  :func:`encode_trace` applies the LUT through the byte-LUT
kernel (``kernels/byte_lut``) on the card, adds the one-cycle LUT latency
for optimized/owi (Section 10.1), re-places the refreshes and lints the
result.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dram import (RD, WR, CommandTrace, LINE_BYTES,
                                   host_array)

ENCODINGS = ("baseline", "bdi", "optimized", "owi")


def _u32(lines) -> np.ndarray:
    """Lines (numpy, or an int32 bit-pattern tensor) as host uint32."""
    return host_array(lines).astype(np.uint32)


# ---------------------------------------------------------------------------
# byte <-> word helpers (numpy, vectorized over lines)
# ---------------------------------------------------------------------------
def words_to_bytes(lines) -> np.ndarray:
    """(n, 16) uint32 -> (n, 64) uint8."""
    lines = _u32(lines)
    out = np.empty(lines.shape[:-1] + (LINE_BYTES,), dtype=np.uint8)
    for i in range(4):
        out[..., i::4] = (lines >> (8 * i)) & 0xFF
    return out


def bytes_to_words(b: np.ndarray) -> np.ndarray:
    """(n, 64) uint8 -> (n, 16) uint32."""
    b = np.asarray(b, dtype=np.uint32)
    return (b[..., 0::4] | (b[..., 1::4] << 8) | (b[..., 2::4] << 16)
            | (b[..., 3::4] << 24)).astype(np.uint32)


def byte_histogram(lines) -> np.ndarray:
    return np.bincount(words_to_bytes(lines).reshape(-1), minlength=256)


# ---------------------------------------------------------------------------
# Optimized / OWI
# ---------------------------------------------------------------------------
def popcount_sorted_codes() -> np.ndarray:
    """All byte values sorted by (popcount, value): the code alphabet."""
    vals = np.arange(256)
    pc = np.array([bin(v).count("1") for v in range(256)])
    return vals[np.lexsort((vals, pc))].astype(np.uint8)


def optimized_lut(hist: np.ndarray) -> np.ndarray:
    """byte value -> encoded byte, most frequent value gets fewest ones."""
    order = np.argsort(-np.asarray(hist), kind="stable")  # freq desc
    codes = popcount_sorted_codes()
    lut = np.empty(256, dtype=np.uint8)
    lut[order] = codes
    return lut


def apply_lut(lines, lut: np.ndarray) -> np.ndarray:
    return bytes_to_words(np.asarray(lut)[words_to_bytes(lines)])


def invert_lines(lines) -> np.ndarray:
    return (~_u32(lines)).astype(np.uint32)


# ---------------------------------------------------------------------------
# BDI (Base-Delta-Immediate) [127]
# schemes evaluated per 64 B line, smallest encoded size wins:
#   zeros(1B) | rep8(8B) | b8d1(16B) | b8d2(24B) | b8d4(40B)
#   | b4d1(20B) | b4d2(36B) | b2d1(34B) | raw(64B)
# ---------------------------------------------------------------------------
def _fits(deltas: np.ndarray, nbytes: int) -> np.ndarray:
    lim = 1 << (8 * nbytes - 1)
    return np.all((deltas >= -lim) & (deltas < lim), axis=-1)


def bdi_encode_lines(lines) -> tuple[np.ndarray, np.ndarray]:
    """Encode each line with the best BDI scheme.

    Returns (encoded_lines (n,16) uint32, encoded_size_bytes (n,) int32).
    The encoded line is the compressed representation packed at the start
    and zero padding after (what would sit on the bus / in the cells).
    """
    lines = _u32(lines)
    n = lines.shape[0]
    by = words_to_bytes(lines)                       # (n, 64)
    best = np.full(n, 64, dtype=np.int32)
    out = by.copy()

    def consider(mask, size, encoded_bytes):
        nonlocal best, out
        mask = mask & (size < best)
        if not np.any(mask):
            return
        buf = np.zeros((int(mask.sum()), LINE_BYTES), dtype=np.uint8)
        eb = encoded_bytes[mask]
        buf[:, :eb.shape[1]] = eb
        out[mask] = buf
        best[mask] = size

    # all-zeros
    consider(np.all(by == 0, axis=1), 1, np.zeros((n, 1), dtype=np.uint8))

    for base_bytes, delta_bytes in ((8, 1), (8, 2), (8, 4),
                                    (4, 1), (4, 2), (2, 1)):
        k = LINE_BYTES // base_bytes
        vals = np.zeros((n, k), dtype=np.int64)
        for i in range(base_bytes):
            vals |= by[:, i::base_bytes].astype(np.int64) << (8 * i)
        # interpret as signed for delta arithmetic
        sign = np.int64(1) << (8 * base_bytes - 1)
        if base_bytes < 8:
            vals = (vals ^ sign) - sign
        base = vals[:, :1]
        deltas = vals - base
        ok = _fits(deltas, delta_bytes)
        size = base_bytes + k * delta_bytes
        # also the repeated-value special case (all deltas zero)
        rep = np.all(deltas == 0, axis=1)
        enc = np.zeros((n, size), dtype=np.uint8)
        for i in range(base_bytes):
            enc[:, i] = (base[:, 0] >> (8 * i)) & 0xFF
        d = deltas.astype(np.int64)
        for j in range(k):
            for i in range(delta_bytes):
                enc[:, base_bytes + j * delta_bytes + i] = (
                    (d[:, j] >> (8 * i)) & 0xFF)
        consider(rep, base_bytes,
                 enc[:, :base_bytes].reshape(n, base_bytes))
        consider(ok & ~rep, size, enc)

    return bytes_to_words(out), best


# ---------------------------------------------------------------------------
# Trace-level application
# ---------------------------------------------------------------------------
def encode_trace(trace: CommandTrace, encoding: str,
                 lut: np.ndarray | None = None,
                 conform_refresh: bool = True,
                 device=None) -> CommandTrace:
    """Rewrite RD/WR data per the encoding; optimized/owi add one cycle of
    LUT latency to every RD/WR (Section 10.1).  An encoded trace comes
    back as CPU tensors.

    The LUT runs through the byte-LUT kernel on ``device`` (``cuda``
    unless the caller names another, ``model_api.resolve_device``).  The
    added LUT cycles stretch the trace, which would push the refreshes
    ``traces.app_trace`` scheduled past the tREFI deadline, so by default
    the refresh schedule is recomputed afterwards
    (``traces.reschedule_refresh``) and the result linted;
    ``conform_refresh=False`` keeps the raw stretched trace for
    slot-by-slot comparisons."""
    if encoding == "baseline":
        return trace
    trace = trace.to("cpu")
    is_rw = (trace.cmd == RD) | (trace.cmd == WR)
    data = trace.data.clone()
    dt = trace.dt.clone()
    lut_latency = False

    if encoding == "bdi":
        enc, _ = bdi_encode_lines(data[is_rw])
        data[is_rw] = torch.from_numpy(enc.view(np.int32))
    elif encoding in ("optimized", "owi"):
        from repro_torch.core.model_api import resolve_device
        from repro_torch.kernels.byte_lut import ops as lut_ops
        if lut is None:
            lut = optimized_lut(byte_histogram(data[is_rw]))
        dev = resolve_device(device)
        table = torch.from_numpy(np.asarray(lut).astype(np.int32))
        enc = lut_ops.apply_lut_lines(data[is_rw].to(dev), table).cpu()
        if encoding == "owi":
            wr_mask = trace.cmd[is_rw] == WR
            enc[wr_mask] = ~enc[wr_mask]
        data[is_rw] = enc
        dt[is_rw] += 1  # LUT adds one DRAM cycle
        lut_latency = True
    else:
        raise ValueError(encoding)

    out = trace._replace(data=data, dt=dt)
    if lut_latency and conform_refresh:
        from repro_torch.analysis import trace_lint
        from repro_torch.core import traces as traces_lib
        out = traces_lib.reschedule_refresh(out)
        trace_lint.check_generated(out, "encodings.encode_trace")
    return out


def encode_all(traces_by_app: dict[str, CommandTrace],
               device=None) -> list[CommandTrace]:
    """Every app's trace under every encoding, app-major (the batch
    :func:`encoding_energy_study` scores)."""
    return [encode_trace(traces_by_app[app], enc, device=device)
            for app in traces_by_app for enc in ENCODINGS]


def encoding_energy_study(traces_by_app: dict[str, CommandTrace],
                          model, vendors=None
                          ) -> dict[str, dict[str, float]]:
    """Total DRAM energy (pJ) of every (app, encoding) pair, averaged over
    ``vendors``, scored in ONE batched dispatch.

    ``model`` is any estimator implementing the unified protocol
    (``repro_torch.core.model_api``); the LUT runs on its device.  All
    ``len(traces_by_app) x 4`` encoded traces are padded into a single
    ``estimate_batch.TraceBatch`` and the full (traces x vendors) report
    matrix comes from one ``model.estimate`` call."""
    vendors = list(model.vendors) if vendors is None else list(vendors)
    encoded = encode_all(traces_by_app, device=model.device)
    return study_table(list(traces_by_app), model.estimate(encoded, vendors))


def study_table(apps: list[str], rep) -> dict[str, dict[str, float]]:
    """An app-major ``(apps x 4 encodings, vendors)`` report -> energy
    (pJ) per (app, encoding), averaged over the vendors in float64."""
    energy = rep.energy_pj.cpu().numpy().astype(np.float64).mean(axis=1)
    energy = energy.reshape(len(apps), len(ENCODINGS))
    return {app: {enc: float(energy[i, j])
                  for j, enc in enumerate(ENCODINGS)}
            for i, app in enumerate(apps)}

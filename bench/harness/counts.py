"""Bytes and operations of the estimation path, and the least time the
card could take for them.

The constants are ``chip_smoke.py``'s (origin: commit 3b119a0:
``FEATURE_LINE_BYTES``'s parts, ``charge_rows``' 8 planes of 4 B, 123
float32 parameters a set and 45 operations a command and set, ``bound``),
but a count takes only what these inputs need: a slot that is padding
(weight 0) needs only its weight read (and, in the feature kernel, its
command read and its two features written); only a RD or WR needs its
64-byte line; only real commands cost charge operations.  A kernel that
skips padding cannot beat these, so a share of them never passes 100 %
by an over-count (``chip_smoke.py`` counts every padded slot at 80 B in
the feature kernel).
"""
from __future__ import annotations

import dataclasses

#: float32 parameters a set, as the charge kernels load them
PARAM_FLOATS = 123
#: operations a (command, parameter set) pair costs in the charge kernel
CHARGE_OPS = 45
#: operations a line costs in the feature kernel (two 512-bit popcounts)
FEATURE_OPS = 64
#: leaves of an energy report
REPORT_LEAVES = 5


def bound_s(nbytes: float, nops: float, peaks: dict) -> tuple[float, str]:
    """The least time (s): bytes over the memory rate or float32
    operations over the float32 rate, whichever is larger."""
    t_bytes = nbytes / peaks["hbm_bytes_per_s"]
    t_ops = nops / peaks["fp32_ops_per_s"]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- what the inputs need ---------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Work:
    """One call's inputs, as the counts see them."""
    traces: int        # T, the traces of the call
    slots: int         # T x N command slots, padding included
    real: int          # commands of weight 1
    rw: int            # RD and WR commands among them
    sets: int          # parameter sets each command is scored against
    cells: int         # report entries a (trace, set) pair: 1 or 64

    @property
    def scored(self) -> int:
        """(command, parameter set) scores the call delivers."""
        return self.real * self.sets


def features_need(w: Work) -> tuple[int, int]:
    """Every slot's command read and two features written; a RD or WR's
    line and previous-command index read besides."""
    return w.slots * 12 + w.rw * 68, w.rw * FEATURE_OPS


def charge_need(w: Work) -> tuple[int, int]:
    """A real command's eight planes and a pad slot's weight read, every
    set's parameters read and the charge output written once."""
    nbytes = (w.real * 8 * 4 + (w.slots - w.real) * 4
              + w.sets * PARAM_FLOATS * 4 + w.traces * w.sets * w.cells * 4)
    return nbytes, w.real * w.sets * CHARGE_OPS


def call_need(w: Work) -> tuple[int, int]:
    """The whole call: each input read once (a real command's five
    fields and weight, a RD or WR's line, a pad slot's weight, the
    parameters) and the report's five leaves written once; the charge
    operations."""
    nbytes = (w.real * 6 * 4 + w.rw * 64 + (w.slots - w.real) * 4
              + w.sets * PARAM_FLOATS * 4
              + REPORT_LEAVES * w.traces * w.sets * w.cells * 4)
    return nbytes, w.real * w.sets * CHARGE_OPS

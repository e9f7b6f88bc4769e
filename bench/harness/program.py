"""The system under test's common part.  A cell's entry, the code that
calls ``repro_torch``, is ``entries/<model>.<entry>.py``, found by the
configuration's ``model`` and the mix's ``entry``; it defines a
``Program``, a subclass of :class:`Program` here, whose ``setup`` loads
what the calls need and whose ``enter`` makes one call.

The harness imports the program only through these modules.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import traffic as tf


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Program:
    """One configuration's entry under one mix: ``call(b)`` runs a call on
    device batch ``b`` and returns ``(output, ns when the entry
    returned)``; the output's leaves are ready to read.  ``n_sets`` is
    the number of parameter sets (vendors, modules) a command is scored
    against."""

    n_sets: int

    def __init__(self, root, cfg: dict, mix: dict, inputs: tf.Inputs,
                 device):
        self.device = torch.device(device)
        self.mix = mix
        self.mode = mix["mode"]
        self.batches = self.device_batches(inputs)
        self.setup(root, cfg, inputs)
        sync(self.device)

    def device_batches(self, inputs: tf.Inputs) -> list:
        """Each device batch as a ``TraceBatch`` of the pool's rows."""
        from repro_torch.core.dram import CommandTrace
        from repro_torch.core.estimate_batch import TraceBatch
        pool = {f: torch.from_numpy(x).to(self.device)
                for f, x in inputs.pool.items()}
        out = []
        for order in inputs.orders:
            idx = torch.from_numpy(np.asarray(order, np.int64)).to(
                self.device)
            out.append(TraceBatch(
                CommandTrace(*(pool[f].index_select(0, idx).contiguous()
                               for f in tf.FIELDS)),
                pool["weight"].index_select(0, idx).contiguous()))
        return out

    def setup(self, root, cfg: dict, inputs: tf.Inputs) -> None:
        """Load what the calls need and set ``n_sets``."""
        raise NotImplementedError

    def enter(self, batch):
        """One call of the entry point on ``batch``."""
        raise NotImplementedError

    def call(self, b: int):
        out = self.enter(self.batches[b])
        t_ret = time.perf_counter_ns()
        if self.mix["result"] == "host":
            out = out.to("cpu")
        else:
            sync(self.device)
        return out, t_ret

    def leaves(self, out) -> dict:
        """An output's leaves by name (an ``EnergyReport``'s fields)."""
        return dict(zip(out._fields, out))

    def free(self) -> None:
        """Drop the program's state: everything ``setup`` and the batches
        hold."""
        keep = {"device", "mix", "mode", "n_sets"}
        for name in [k for k in vars(self) if k not in keep]:
            delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

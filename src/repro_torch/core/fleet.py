"""The stacked-parameter core shared by the batched engines (the
estimation dispatch here; the characterization campaign in a later
slice)."""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.dram import CommandTrace
from repro_torch.core.energy_model import (PowerParams, StructuralFeatures,
                                           charge_from_features,
                                           finalize_features, masked_cycles)


def stack_params(params: Sequence[PowerParams]) -> PowerParams:
    """Stack per-module parameter sets along a leading module axis (one
    ``torch.stack`` per leaf)."""
    return PowerParams(*(torch.stack(leaves) for leaves in zip(*params)))


def batched_pair_totals(tr: CommandTrace, w: torch.Tensor,
                        sf: StructuralFeatures, stacked: PowerParams):
    """Masked charge of every (trace, paramset) pair and the masked cycles
    of every trace -> ``((..., V), (...,))``.  The structural pass ``sf``
    ran once for the batch; only the open-bank finalize and the charge
    integration run per parameter set."""
    charges = []
    for v in range(stacked.i2n.shape[0]):
        pp = stacked.select(v)
        c = charge_from_features(tr, finalize_features(sf, pp), pp)
        charges.append((c * w).sum(dim=-1))
    return torch.stack(charges, dim=-1), masked_cycles(tr, w)

"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet for the H100 SXM, dense rates without sparsity, at its full power
limit of 700 W)."""
from __future__ import annotations

H100_SXM = {"hbm_bytes_per_s": 3.35e12, "fp32_ops_per_s": 67e12}

#: by ``torch.cuda.get_device_name()``
PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks_for(kind: str) -> dict | None:
    """The peaks of a card, or None for a card the table lacks (its
    rooflines are then not reported)."""
    return PEAKS.get(kind)

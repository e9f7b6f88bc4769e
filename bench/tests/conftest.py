"""CPU tests of the benchmark (``python -m pytest bench/tests`` from the
repo's root; the card tests are marked ``cuda`` and skip without one)."""
import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

#: each cell's traffic and configuration cut to a size a CPU test holds
SMALL = {"requests_per_trace": 30, "traces_per_call": 6, "padded_len": 256,
         "device_batches": 2}
TINY = {
    "vampire-ddr3l.batch-long": {"traffic": SMALL},
    "vampire-ddr3l.surface-long": {"traffic": SMALL},
    "vampire-ddr3l.batch-short": {"traffic": {**SMALL, "pool_per_app": 2,
                                              "traces_per_call": 12}},
    "vampire-fleet10k.map-spec": {
        "traffic": {**SMALL, "traces_per_call": 23, "module_chunk": 16},
        "config": {"params": {"kind": "synthetic_fleet", "n_modules": 40,
                              "year": 2015}}},
}


def tiny(workload: str) -> dict:
    """The overrides that cut ``workload`` to a CPU test's size (a cell
    this table lacks runs at the mix's own sizes, cut by ``SMALL``)."""
    return TINY.get(workload, {"traffic": SMALL})


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")

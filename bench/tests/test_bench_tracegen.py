"""The benchmark's frozen copies against the program they were copied
from: the trace generator gives the port's commands for the port's seed,
and the fleet draw starts from the port's vendor parameters."""
import numpy as np
import pytest
from conftest import ROOT

from harness import core, fleet, tracegen
from repro_torch.core import device_sim, traces

DRAM = tracegen.Dram.from_config(
    core.load_json(ROOT / "bench/configs/vampire-ddr3l.json"))


@pytest.mark.parametrize("app", [0, 3, 7, 21, 22])
def test_the_copy_gives_the_ports_commands_for_the_same_seed(app):
    spec = traces.SPEC_APPS[app]
    want = traces.app_trace(spec, n_requests=400)
    got = tracegen.app_trace(tracegen.SPEC_APPS[app], 400, DRAM,
                             entropy=(29, spec.seed))
    for field in ("cmd", "bank", "row", "col", "data", "dt"):
        assert np.array_equal(getattr(want, field).numpy(), got[field]), \
            field


def test_the_apps_and_the_configs_dram_are_the_ports():
    from repro_torch.core import dram
    assert [a.name for a in tracegen.SPEC_APPS] == [
        a.name for a in traces.SPEC_APPS]
    assert DRAM.timing == dram.TIMING._asdict()
    assert (DRAM.n_banks, DRAM.row_bits, DRAM.cols_per_row,
            DRAM.line_bytes, DRAM.tck_ns, DRAM.vdd) == (
        dram.N_BANKS, dram.ROW_BITS, dram.COLS_PER_ROW, dram.LINE_BYTES,
        dram.TCK_NS, dram.VDD)


@pytest.mark.parametrize("vendor", [0, 1, 2])
def test_the_fleets_vendor_leaves_are_the_ports(vendor):
    want = device_sim._vendor_leaves(vendor, 2015)
    got = fleet.vendor_leaves(vendor, DRAM.timing, 8, 8)
    assert set(got) == set(want)
    for name in want:
        assert np.array_equal(np.asarray(want[name], np.float32),
                              got[name]), name


def test_the_fleet_is_drawn_from_the_seed():
    a = fleet.synth_fleet(30, (5, 1), DRAM.timing)
    b = fleet.synth_fleet(30, (5, 1), DRAM.timing)
    c = fleet.synth_fleet(30, (6, 1), DRAM.timing)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a["i2n"], c["i2n"])
    assert a["datadep"].shape == (30, 4, 2, 3) and a["i2n"].dtype == np.float32
    # every module of a vendor keeps the vendor's structural surface
    assert np.array_equal(a["act_surface"][0], a["act_surface"][3])

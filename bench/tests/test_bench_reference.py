"""The frozen reference is the port's own math: at a small size it gives
``repro_torch``'s ``impl='vectorized'`` reports, integers bit for bit and
energies at the port's rtol, for both configurations."""
import numpy as np
import pytest
import torch
from conftest import ROOT

from harness import core
from harness import traffic as tf
from reference import params as ref_params
from reference import vampire as ref_vampire
from repro_torch.core import fleet, model_api
from repro_torch.core.dram import CommandTrace
from repro_torch.core.energy_model import PowerParams
from repro_torch.core.estimate_batch import TraceBatch

RTOL = 1e-5        # the port's 'cuda' against 'vectorized' bar
FIT = str(ROOT / "bench/data/vampire_quickfit_v2.npz")


def small_inputs(config, seed, **mix):
    cfg = core.load_json(ROOT / f"bench/configs/{config}.json")
    base = dict(core.load_json(ROOT / "bench/traffic/batch-long.json"),
                requests_per_trace=60, traces_per_call=8, padded_len=512,
                device_batches=1)
    base.update(mix)
    if config == "vampire-fleet10k":
        cfg["params"] = dict(cfg["params"], n_modules=24)
    return cfg, tf.make_inputs(cfg, base, seed)


def batch(inp):
    idx = torch.as_tensor(inp.orders[0])
    b = {k: torch.from_numpy(x)[idx] for k, x in inp.pool.items()}
    tb = TraceBatch(CommandTrace(*(b[f] for f in tf.FIELDS)), b["weight"])
    return b, tb


def same_report(got, want):
    assert torch.equal(got.cycles.long(), want["cycles"].long())
    for name in ("charge_ma_cycles", "avg_current_ma", "energy_pj",
                 "time_ns"):
        g, w = getattr(got, name).double(), want[name]
        assert g.shape == w.shape
        assert torch.allclose(g, w, rtol=RTOL, atol=0), name


def test_the_fit_files_parameters_are_the_ports():
    model = model_api.load_estimator(FIT, device="cpu")
    leaves = ref_params.from_fit_file(FIT, (0, 1, 2))
    for name, x in zip(PowerParams._fields, model.fleet.params):
        assert np.array_equal(x.numpy(), leaves[name]), name


@pytest.mark.parametrize("mode", ["mean", "surface"])
@pytest.mark.parametrize("seed", [4, 2**31 + 1])
def test_the_reference_is_the_vectorized_estimate(mode, seed):
    cfg, inp = small_inputs("vampire-ddr3l", seed)
    b, tb = batch(inp)
    model = model_api.load_estimator(FIT, device="cpu")
    got = model.estimate(tb, vendors=(0, 1, 2), mode=mode,
                         impl="vectorized")
    p = ref_params.on_device(ref_params.from_fit_file(FIT, (0, 1, 2)),
                             "cpu")
    want = ref_vampire.estimate(b, p, cfg["dram"],
                                surface=mode == "surface")
    same_report(got, want)


def test_the_reference_is_the_vectorized_fleet_map():
    cfg, inp = small_inputs("vampire-fleet10k", 7, traces_per_call=23,
                            draw="permutation", padded_len=640)
    b, tb = batch(inp)
    stacked = PowerParams(**{k: torch.from_numpy(x)
                             for k, x in inp.fleet.items()})
    got = fleet.fleet_surface_energy(stacked, tb.trace, tb.weight,
                                     impl="vectorized", module_chunk=8)
    want = ref_vampire.estimate(b, ref_params.on_device(inp.fleet, "cpu"),
                                cfg["dram"], surface=True)
    same_report(got, want)

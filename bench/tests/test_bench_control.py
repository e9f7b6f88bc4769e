"""The comparison that decides ``correct`` fails its control and the
faults a cell can have, each through the rest of a run (the harness's
look for a card skipped, the CPU running the kernels' plain versions):

* the control: the plain reference in bfloat16, the precision below the
  configuration's float32, in the program's place;
* half of the batch left out, the mean of the rest in its place;
* one answer altered where it is produced (the largest charge of a
  charge launch 0.1 % high).

A step that returns its state unchanged and an exchange between chips
left out are faults of training and of cells across chips; these cells
have neither."""
import time

import pytest
import torch
from conftest import ROOT, tiny

import control
from harness import check, core
from repro_torch.core.dram import CommandTrace
from repro_torch.core.estimate_batch import TraceBatch
from repro_torch.kernels.vampire_energy import ops as vops

WORKLOADS = [w["name"] for w in core.load_json(ROOT / "BENCHMARK.json")
             ["workloads"]]


def limits(workload):
    return check.load_limits(ROOT / "bench" / "limits" / f"{workload}.json")


def run(workload, wrap=None):
    return core.run_cell(workload, 2**31 + 3, 0.2, False,
                         t_start_ns=time.perf_counter_ns(), device="cpu",
                         overrides=tiny(workload), wrap=wrap)["result"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_fails(workload):
    got = control.readings(workload, 2**31 + 3, torch.bfloat16,
                           device="cpu", overrides=tiny(workload))
    lim = limits(workload)
    assert check.verdict(got["program"], lim)
    assert not check.verdict(got["control"], lim), got


def half_batch(prog):
    real = prog.call

    def call(b):
        full = prog.batches[b]
        t = full.n_traces
        k = t // 2
        prog.batches[b] = TraceBatch(CommandTrace(*(x[:k] for x in
                                                    full.trace)),
                                     full.weight[:k])
        try:
            out, t_ret = real(b)
        finally:
            prog.batches[b] = full
        leaves = [torch.cat([x, x.double().mean(0, keepdim=True).to(x.dtype)
                             .expand((t - k,) + x.shape[1:])]) for x in out]
        return type(out)(*leaves), t_ret
    prog.call = call


@pytest.mark.parametrize("workload", WORKLOADS)
def test_half_the_batch_left_out_fails(workload):
    assert run(workload)["correct"] is True
    assert run(workload, half_batch)["correct"] is False


@pytest.mark.parametrize("workload", WORKLOADS)
def test_an_answer_altered_where_it_is_produced_fails(workload, monkeypatch):
    real = vops.charge_from_planes

    def altered(*args, **kw):
        out = real(*args, **kw).clone()
        out[torch.unravel_index(out.abs().argmax(), out.shape)] *= 1.001
        return out
    monkeypatch.setattr(vops, "charge_from_planes", altered)
    res = run(workload)
    assert res["correct"] is False
    assert res["checks"]["energy_rel_err"]["value"] > 5e-4

"""The count functions against hand counts at small shapes."""
import numpy as np
import pytest
from conftest import ROOT

from harness import counts, core, tracegen
from harness import traffic as tf

PEAKS = {"hbm_bytes_per_s": 3.35e12, "fp32_ops_per_s": 67e12}


def test_need_counts_by_hand():
    # 2 traces x 4 slots: 5 real commands, 3 of them RD/WR; 3 vendors
    w = counts.Work(traces=2, slots=8, real=5, rw=3, sets=3, cells=1)
    assert w.scored == 15
    assert counts.features_need(w) == (8 * 12 + 3 * 68, 3 * 64)
    assert counts.charge_need(w) == (5 * 32 + 3 * 4 + 3 * 123 * 4
                                     + 2 * 3 * 4, 5 * 3 * 45)
    assert counts.call_need(w) == (5 * 24 + 3 * 64 + 3 * 4 + 3 * 123 * 4
                                   + 5 * 2 * 3 * 4, 5 * 3 * 45)
    s = counts.Work(traces=2, slots=8, real=5, rw=3, sets=3, cells=64)
    assert counts.charge_need(s)[0] == counts.charge_need(w)[0] \
        + 2 * 3 * 63 * 4


def test_the_bound_takes_the_larger_time():
    assert counts.bound_s(3.35e12, 1.0, PEAKS) == (1.0, "bytes")
    t, by = counts.bound_s(1.0, 134e12, PEAKS)
    assert by == "operations" and t == pytest.approx(2.0)


def test_a_batch_is_counted_from_its_commands():
    cfg = core.load_json(ROOT / "bench/configs/vampire-ddr3l.json")
    mix = dict(core.load_json(ROOT / "bench/traffic/batch-long.json"),
               requests_per_trace=25, traces_per_call=30, padded_len=200,
               device_batches=2)
    inp = tf.make_inputs(cfg, mix, 9)
    order = inp.orders[1]
    w = tf.work(inp, order, 3, 1)
    real = rw = 0
    for i in order:
        n = int(inp.lengths[i])
        cmd = inp.pool["cmd"][i, :n]
        real += n
        rw += int(np.isin(cmd, (tracegen.RD, tracegen.WR)).sum())
        assert not inp.pool["weight"][i, n:].any()
    assert (w.traces, w.slots, w.real, w.rw) == (30, 30 * 200, real, rw)
    assert rw == 30 * 25              # one RD or WR a request


def test_balanced_batches_hold_every_pool_trace_alike():
    mix = {"traces_per_call": 50, "device_batches": 3, "draw": "balanced"}
    for order in tf.batch_orders(mix, 23, 2**31 + 5):
        hits = np.bincount(order, minlength=23)
        assert hits.min() >= 2 and hits.max() <= 3

"""The port's estimation service against the reference's
(``tests/test_serving.py``): ring bucketing, FIFO vendor-subset windows,
buffers reused in place, every mode equal to a direct ``estimate``,
lint-gated mixed admission, structured rejections, drain/close, the
metrics counters (equal to the reference's for the same burst) and the
bound on distinct dispatch shapes.  Both packages load the committed
schema-v2 quick fit; traces are the reference's validation sweeps carried
across as numpy."""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro import serving as rserving
from repro.core import idd_loops
from repro.core import model_api as rma
from repro_torch.core import dram as pdram
from repro_torch.core import model_api as pma
from repro_torch.core.estimate_batch import (as_trace_batch,
                                             bucketed_trace_batch)
from repro_torch.serving import (EstimationService, RingConfig, ServiceConfig,
                                 TraceRing, TraceTooLongError)

MODEL = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "data" / "vampire_quickfit_v2.npz")
RTOL = 1e-5


@pytest.fixture(scope="module")
def model():
    return pma.load_estimator(str(MODEL), device="cpu")


def _bridge(tr):
    return pdram.make_trace(*[np.asarray(f) for f in tr])


def _ref_sweeps(ns=(1, 8, 16, 64)):
    return [idd_loops.validation_sweep(n) for n in ns]


def _sweeps(ns=(1, 8, 16, 64)):
    return [_bridge(tr) for tr in _ref_sweeps(ns)]


def _corrupt(trace):
    """A protocol-illegal copy: first ACT->PRE gap squeezed to 2 cycles."""
    dt = trace.dt.clone()
    dt[0] = 2
    return trace._replace(dt=dt)


def _close(got, want):
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(),
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# TraceRing
# ---------------------------------------------------------------------------
def test_ring_empty_flush_is_noop():
    ring = TraceRing()
    assert ring.take() is None and len(ring) == 0


def test_ring_pads_to_bucket_shapes_as_an_exact_pad():
    ring = TraceRing(RingConfig(length_buckets=(256,), count_buckets=(4,)))
    traces = _sweeps((1, 8, 16))           # lengths 24, 80, 144
    for tr in traces:
        ring.admit(tr)
    rb = ring.take()
    assert rb.batch.trace.cmd.shape == (4, 256)
    assert rb.tickets == (0, 1, 2)
    assert rb.n_real == 3 and rb.slots == 4 and rb.fill == 0.75
    np.testing.assert_array_equal(rb.batch.weight.sum(dim=1).numpy(),
                                  [tr.n for tr in traces] + [0])
    # the window is bit-equal to the exact bucketed pad of the same traces
    exact = bucketed_trace_batch(traces, 4, 256)
    for a, b in zip(rb.batch.trace, exact.trace):
        assert torch.equal(a, b)
    assert torch.equal(rb.batch.weight, exact.weight)
    assert len(ring) == 0 and ring.take() is None


def test_ring_bucketing_matches_the_exact_pad_estimate(model):
    trs = _sweeps((1, 8, 16))
    ring = TraceRing(RingConfig(length_buckets=(512,), count_buckets=(8,)))
    for tr in trs:
        ring.admit(tr)
    bucketed = model.estimate(ring.take().batch)
    exact = model.estimate(as_trace_batch(trs))
    _close(bucketed.avg_current_ma[:3], exact.avg_current_ma)
    assert torch.equal(bucketed.cycles[:3], exact.cycles)
    assert bool((bucketed.energy_pj[3:] == 0).all())


def test_ring_rejects_trace_longer_than_largest_bucket():
    ring = TraceRing(RingConfig(length_buckets=(64, 128),
                                count_buckets=(4,)))
    with pytest.raises(TraceTooLongError) as ei:
        ring.admit(_sweeps((16,))[0])       # 144 commands
    assert ei.value.n == 144 and ei.value.limit == 128


def test_ring_windows_group_by_vendor_subset_fifo():
    ring = TraceRing(RingConfig(length_buckets=(256,), count_buckets=(4,)))
    trs = _sweeps((1, 4, 8, 16))
    ring.admit(trs[0], group=(0, 1))
    ring.admit(trs[1], group=(0, 1))
    ring.admit(trs[2], group=(2,))
    ring.admit(trs[3], group=(0, 1))
    first = ring.take()
    assert first.group == (0, 1) and first.tickets == (0, 1, 3)
    second = ring.take()
    assert second.group == (2,) and second.tickets == (2,)
    assert ring.take() is None


def test_ring_reuses_pad_buffers_in_place():
    ring = TraceRing(RingConfig(length_buckets=(256,), count_buckets=(4,)))
    ring.admit(_sweeps((8,))[0])
    first = ring.take()
    held = first.batch.trace.cmd.clone()
    buffers = {k: v.data_ptr() for k, v in ring._buffers[(4, 256)].items()}
    ring.admit(_sweeps((16,))[0])
    ring.take()
    assert list(ring._buffers) == [(4, 256)]   # one persistent buffer set
    assert {k: v.data_ptr() for k, v in
            ring._buffers[(4, 256)].items()} == buffers
    assert torch.equal(first.batch.trace.cmd, held)   # windows are copies


def test_ring_max_batch_caps_window():
    ring = TraceRing(RingConfig(length_buckets=(256,), count_buckets=(2, 4)))
    for tr in _sweeps((1, 4, 8)):
        ring.admit(tr)
    rb = ring.take(max_batch=2)
    assert rb.tickets == (0, 1) and rb.slots == 2
    assert len(ring) == 1


# ---------------------------------------------------------------------------
# EstimationService
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode,kwargs", [
    ("mean", {}), ("range", {}), ("surface", {}),
    ("distribution", dict(ones_frac=0.5, toggle_frac=0.25))])
@pytest.mark.parametrize("impl", ["vectorized", "cuda"])
def test_service_every_mode_matches_direct_estimate(model, mode, kwargs,
                                                    impl):
    trs = _sweeps()
    svc = EstimationService(model, ServiceConfig(mode=mode, impl=impl,
                                                 **kwargs))
    tickets, rejections = svc.submit_many(trs)
    assert not rejections
    assert svc.drain() == len(trs)
    direct = model.estimate(trs, mode=mode, **kwargs)
    for i, t in enumerate(tickets):
        row = svc.result(t)
        got, want = ((row,), (direct,)) if mode != "range" else (row, direct)
        for g, w in zip(got, want):
            _close(g.energy_pj, w.energy_pj[i])


def test_service_vendor_subset_requests(model):
    trs = _sweeps((1, 8, 16))
    svc = EstimationService(model, ServiceConfig())
    ta, _ = svc.submit_many(trs[:2], vendors=(1, 2))
    tb, _ = svc.submit_many(trs[2:], vendors=(0,))
    assert svc.drain() == 3 and svc.metrics().dispatches == 2
    direct12 = model.estimate(trs[:2], (1, 2))
    direct0 = model.estimate(trs[2:], (0,))
    for i, t in enumerate(ta):
        row = svc.result(t).avg_current_ma
        assert row.shape == (2,)
        _close(row, direct12.avg_current_ma[i])
    _close(svc.result(tb[0]).avg_current_ma, direct0.avg_current_ma[0])


def test_service_mixed_admission_rejects_and_still_dispatches(model):
    legal = _sweeps((8, 16))
    bad = _corrupt(legal[0])
    svc = EstimationService(model, ServiceConfig())
    tickets, rejections = svc.submit_many([legal[0], bad, legal[1]])
    assert tickets[1] is None and len(rejections) == 1
    assert rejections[0].reason == "protocol" and rejections[0].rules
    assert rejections[0].diagnostics[0].rule
    assert svc.drain() == 2
    direct = model.estimate(legal)
    for i, t in enumerate((tickets[0], tickets[2])):
        _close(svc.result(t).avg_current_ma, direct.avg_current_ma[i])
    m = svc.metrics()
    assert m.admitted == 2 and m.rejected == 1
    assert sum(m.rejected_by_rule.values()) >= 1
    assert svc.rejections == tuple(rejections)


def test_service_too_long_is_a_structured_rejection(model):
    svc = EstimationService(model, ServiceConfig(
        ring=RingConfig(length_buckets=(64,), count_buckets=(4,))))
    r = svc.submit(_sweeps((16,))[0])       # 144 > 64
    assert r.reason == "too-long" and r.rules == ("too-long",)
    assert svc.metrics().rejected_by_rule == {"too-long": 1}


def test_service_shutdown_drain_and_close(model):
    trs = _sweeps((1, 8, 16, 64, 4))
    svc = EstimationService(model, ServiceConfig(max_batch=2))
    tickets, _ = svc.submit_many(trs)
    assert svc.close() == len(trs)
    for t in tickets:
        assert svc.result(t).energy_pj.shape == (3,)
    with pytest.raises(RuntimeError):
        svc.submit_many(trs[:1])
    m = svc.metrics()
    assert m.queue_depth == 0 and m.completed == len(trs)
    assert m.dispatches == 3                # windows of <= 2


def test_service_metrics_snapshot(model):
    svc = EstimationService(model, ServiceConfig())
    svc.submit_many(_sweeps((1, 8)))
    assert svc.metrics().queue_depth == 2
    assert svc.maybe_step() == 2 and svc.maybe_step() == 0
    m = svc.metrics()
    assert dataclasses.asdict(m)
    assert m.dispatched_traces == 2 and m.batch_fill == pytest.approx(0.25)
    assert m.traces_per_s > 0
    assert m.latency_p99_ms >= m.dispatch_p50_ms > 0
    assert m.engine_programs == 1
    assert (m.drift_score, m.recalibrations) == (0.0, 0)


def test_service_result_before_dispatch_raises(model):
    svc = EstimationService(model, ServiceConfig())
    t = svc.submit(_sweeps((1,))[0])
    with pytest.raises(KeyError):
        svc.result(t)
    svc.drain()
    svc.result(t)


def test_metrics_counts_equal_the_reference_for_the_same_burst(model):
    ref_model = rma.load_estimator(str(MODEL))
    ref_trs = _ref_sweeps((1, 8, 16, 64, 4, 2))
    ref_bad = ref_trs[1]._replace(dt=ref_trs[1].dt.at[0].set(2))
    ring = dict(length_buckets=(64, 256, 1024), count_buckets=(2, 4))
    ref_svc = rserving.EstimationService(ref_model, rserving.ServiceConfig(
        ring=rserving.RingConfig(**ring), max_batch=3))
    svc = EstimationService(model, ServiceConfig(ring=RingConfig(**ring),
                                                 max_batch=3))
    for s, trs, bad in ((ref_svc, ref_trs, ref_bad),
                        (svc, [_bridge(t) for t in ref_trs],
                         _bridge(ref_bad))):
        s.submit_many(trs[:3] + [bad], vendors=(0, 2))
        s.submit_many(trs[3:], vendors=(1,))
        s.step()
        s.close()
    want, got = (dataclasses.asdict(s.metrics()) for s in (ref_svc, svc))
    for key in ("admitted", "rejected", "rejected_by_rule", "dispatches",
                "dispatched_traces", "completed", "queue_depth",
                "batch_fill", "engine_programs"):
        assert got[key] == want[key], key


def test_dispatch_shapes_stay_bounded_by_the_ring_vocabulary(model):
    cfg = RingConfig(length_buckets=(128, 512, 2048), count_buckets=(2, 4))
    svc = EstimationService(model, ServiceConfig(ring=cfg))
    rng = np.random.default_rng(0)
    pool = _sweeps((1, 4, 8, 16, 32, 64, 128))
    for _ in range(12):
        picks = rng.choice(len(pool), size=int(rng.integers(1, 6)))
        svc.submit_many([pool[i] for i in picks])
        svc.drain()
    limit = len(cfg.count_buckets) * len(cfg.length_buckets)
    assert 1 < svc.engine.cache_size() <= limit


def test_update_model_applies_new_parameters(model):
    trs = _sweeps((1, 8))
    svc = EstimationService(model, ServiceConfig())
    t0, _ = svc.submit_many(trs)
    svc.drain()
    before = svc.result(t0[0]).avg_current_ma
    fm = model.fleet
    bumped = dataclasses.replace(model, fleet=fm._replace(
        params=type(fm.params)(*(x * 1.05 for x in fm.params))))
    svc.engine.update_model(bumped)
    t1, _ = svc.submit_many(trs)
    svc.drain()
    assert not torch.allclose(svc.result(t1[0]).avg_current_ma, before)

"""The readers of the program's spans (``harness/program_spans.py``) on
hand-made traced runs: a known clock offset, self times, the recorder's
own time, idle gaps, overlapping device operations, synced calls and
later calls cut by their counts; None without a trace or without
spans."""
import sys
from types import SimpleNamespace

import numpy as np
import pytest
from conftest import ROOT

import repro_torch
from harness import core, profile, program_spans
from repro_torch import spans as spans_mod

US = 1000                       # the hand-made times are in microseconds
OFFSET = 1_700_000_000 * 10**9  # perf_counter_ns -> the profiler's clock
NEW = ("entry_self_host_ms", "bookkeeping_host_ms", "state_device_ms",
       "pack_device_ms", "report_device_ms", "program_idle_ms")


def _span(name, id, parent, root, outer, inner, synced=False, **counts):
    return SimpleNamespace(
        name=name, id=id, parent=parent, root=root, synced=synced,
        outer_start_ns=outer[0] * US, start_ns=inner[0] * US,
        end_ns=inner[1] * US, outer_end_ns=outer[1] * US, counts=counts)


def made_spans(synced=False):
    y = synced
    return [
        # call 0: the root [5, 95] over state, charge, report, each with
        # the recorder's work at its edges (its outer interval)
        _span("state", 2, 1, 1, (9, 41), (10, 40), y),
        _span("charge", 3, 1, 1, (44, 61), (45, 60), y, launches=1),
        _span("report", 4, 1, 1, (61, 91), (62, 90), y),
        _span("estimate", 1, None, 1, (4, 96), (5, 95), y),
        # call 1: the root [155, 245] over state, pack, report
        _span("state", 6, 5, 5, (160, 200), (160, 200), y),
        _span("pack", 7, 5, 5, (200, 210), (200, 210), y),
        _span("report", 8, 5, 5, (210, 240), (210, 240), y),
        _span("estimate", 5, None, 5, (154, 246), (155, 245), y),
    ]


def made_run(traced=True, calls=None, busy=None):
    calls = calls or [core.Call(0, 0, 100 * US, 130 * US, True),
                      core.Call(1, 150 * US, 250 * US, 280 * US, True)]
    # device operations; two overlap ([30, 45] and [40, 50])
    busy = busy or [(0, 7), (30, 45), (40, 50), (70, 120), (160, 170),
                    (190, 260)]
    trace = profile.Trace(
        [f"op{i}" for i in range(len(busy))],
        np.asarray([s * US + OFFSET for s, _ in busy], np.int64),
        np.asarray([e * US + OFFSET for _, e in busy], np.int64),
        profile.host_spans(calls, OFFSET)) if traced else None
    return core.Run({}, {}, {}, 0.0, calls, 0.28e-3, [], None, None, trace)


@pytest.fixture
def drained(monkeypatch):
    """The program's buffer holds ``made_spans()``; counts the drains."""
    state = {"drains": 0, "spans": made_spans()}

    def drain():
        state["drains"] += 1
        out, state["spans"] = state["spans"], []
        return out

    monkeypatch.setattr(spans_mod, "drain", drain)
    monkeypatch.setattr(spans_mod, "SYNC_GAP_NS", 4 * US)
    return state


def ms(us_total):
    """Microseconds over the window's two calls -> ms a call."""
    return us_total / 2 / 1000


def test_each_reader_reads_the_hand_made_run(drained):
    run = made_run()
    assert program_spans.offset_ns(run) == OFFSET
    entry = program_spans.entry_self_host_ms(run)
    # root self: 90 - (32 + 17 + 30) and 90 - (40 + 10 + 30)
    assert entry["value"] == pytest.approx(ms(11 + 10))
    assert entry["root_ms"] == pytest.approx(ms(90 + 90))
    assert entry["recorder_ms"] == pytest.approx(ms(2 * 4 + 2))
    assert entry["device_unread"] == "no synced call"
    assert entry["counts"] == {"charge.launches": 0.5}
    book = program_spans.bookkeeping_host_ms(run)
    assert book["by_span"] == pytest.approx(
        {"state": ms(30 + 40), "pack": ms(10), "report": ms(28 + 30)})
    assert book["value"] == pytest.approx(ms(138))
    assert drained["drains"] == 1          # once a run, kept on it


def test_idle_time_is_put_down_to_the_span_it_fell_in(drained):
    run = made_run()
    got = program_spans.program_idle_ms(run)
    # idle gaps: [7, 30] [50, 70] [120, 160] [170, 190] [260, 280]
    assert got["by_span"] == pytest.approx(
        {"estimate": ms(2 + 5), "state": ms(20 + 20), "charge": ms(10),
         "report": ms(8), "pack": 0.0})
    assert got["value"] == pytest.approx(ms(65))
    assert got["outside"] == pytest.approx(ms(58))
    assert got["outside_by"] == pytest.approx(
        {"call": ms(4), "sync_copy": ms(10 + 20), "between_calls": ms(20),
         "recorder": ms(4)})
    window_idle = ms(23 + 20 + 40 + 20 + 20)
    assert got["value"] + got["outside"] == pytest.approx(window_idle)
    assert sum(got["by_span"].values()) == pytest.approx(got["value"])
    assert sum(got["outside_by"].values()) == pytest.approx(got["outside"])
    # device_idle_share's reading of the same run, times its window
    share = core.load_reader(ROOT, "device_idle_share")(run)
    assert share / 100 * run.window_s * 1e3 / 2 == pytest.approx(window_idle)


def test_the_recorders_own_time_is_in_no_span(drained):
    """A root's time is its own, its children's and the recorder's work
    at its children's edges, each counted once."""
    run = made_run()
    entry = program_spans.entry_self_host_ms(run)
    kids = ms(30 + 15 + 28 + 40 + 10 + 30)       # the children's own
    roots_recorder = ms(1 + 1 + 1 + 1)            # outside the roots
    assert entry["value"] + kids + (entry["recorder_ms"] - roots_recorder) \
        == pytest.approx(entry["root_ms"])
    assert program_spans.bookkeeping_host_ms(run)["value"] + ms(15) == \
        pytest.approx(kids)                       # and charge's 15


def test_a_full_buffer_reads_none(monkeypatch, drained):
    monkeypatch.setattr(spans_mod, "KEEP", len(made_spans()))
    assert all(getattr(program_spans, m)(made_run()) is None for m in NEW)


def test_the_metric_files_read_through_the_harness(drained):
    drained["spans"], run = cut_run()
    got = {m: core.load_reader(ROOT, m)(run) for m in NEW}
    assert all(v is not None for v in got.values())
    assert got["state_device_ms"]["value"] == pytest.approx(44 / 1000)
    want = {m["name"] for m in core.load_json(ROOT / "BENCHMARK.json")[
        "per_layer"] if m["source"] == "program_span"}
    assert want == set(NEW)


@pytest.mark.parametrize("metric", NEW)
def test_none_without_a_trace_or_without_spans(monkeypatch, drained,
                                               metric):
    read = getattr(program_spans, metric)
    assert read(made_run(traced=False)) is None
    assert drained["drains"] == 0          # nothing drained without a trace
    drained["spans"] = []
    assert read(made_run()) is None
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert read(made_run()) is None       # a program with no recorder


@pytest.mark.parametrize("metric", ["state_device_ms", "pack_device_ms",
                                    "report_device_ms"])
def test_a_device_reader_needs_device_times(drained, metric):
    """Without a synced call no call's operations can be put down."""
    drained["spans"] = made_spans(synced=False)
    run = made_run()
    assert getattr(program_spans, metric)(run) is None
    entry = program_spans.entry_self_host_ms(run)
    assert "root_device_ms" not in entry and entry["value"] > 0


def cut_run(extra=False):
    """A synced call (its device idles 4 µs around each span edge), a
    later call of the same batch whose device lags its host; with
    ``extra`` a third whose operations do not add up to the synced
    call's."""
    starts = (0, 200, 400) if extra else (0, 200)
    calls = [core.Call(0, t * US, (t + 60) * US, (t + 110) * US, True)
             for t in starts]
    y = True
    spans = [
        _span("state", 2, 1, 1, (8, 40), (13, 30), y),
        _span("pack", 3, 1, 1, (40, 55), (45, 50), y),
        _span("report", 4, 1, 1, (55, 75), (60, 68), y),
        _span("estimate", 1, None, 1, (1, 99), (6, 94), y),
    ]
    for k, t in ((5, 200), (9, 400))[:len(starts) - 1]:
        spans += [
            _span("state", k + 1, k, k, (t + 3, t + 15), (t + 4, t + 14)),
            _span("pack", k + 2, k, k, (t + 15, t + 20), (t + 16, t + 19)),
            _span("report", k + 3, k, k, (t + 20, t + 40), (t + 21, t + 39)),
            _span("estimate", k, None, k, (t + 1, t + 59), (t + 2, t + 58))]
    busy = [(7, 8), (14, 22), (22, 35), (46, 50), (61, 70), (100, 104),
            (203, 204), (206, 230), (230, 250), (250, 255), (255, 267),
            (280, 285)]
    if extra:                                        # one operation more
        busy += [(403, 404), (406, 430), (430, 450), (450, 455),
                 (455, 460), (460, 467), (480, 485)]
    return spans, made_run(calls=calls, busy=busy)


def test_later_calls_are_cut_by_the_synced_calls_counts(drained):
    drained["spans"], run = cut_run()
    # the synced call: estimate 1, state 8 + 13, pack 4, report 9, 4 after
    # it; the next call by those counts: 1, 24 + 20, 5, 12, 5 (the synced
    # call itself is not read)
    def value(got):
        assert got["calls_read"] == 0.5
        return got["value"]
    assert value(program_spans.state_device_ms(run)) == \
        pytest.approx(44 / 1000)
    assert value(program_spans.pack_device_ms(run)) == \
        pytest.approx(5 / 1000)
    assert value(program_spans.report_device_ms(run)) == \
        pytest.approx(12 / 1000)
    entry = program_spans.entry_self_host_ms(run)
    assert entry["root_device_ms"] == pytest.approx(62 / 1000)
    assert entry["children_device_ms"] == pytest.approx(61 / 1000)
    assert entry["first_op_lag_us"] == pytest.approx([3, 3])


@pytest.mark.parametrize("shift", [-10, 0, 8])
def test_a_synced_call_is_put_on_the_traces_clock(drained, shift):
    """The trace's clock off the host's by more than half a gap (2 µs),
    which would move operations across the synced call's edges: the call
    is aligned by its idle gaps and the counts hold."""
    spans, run = cut_run()
    run.trace.start_ns += shift * US
    run.trace.end_ns += shift * US
    drained["spans"] = spans
    assert program_spans.state_device_ms(run)["value"] == pytest.approx(
        44 / 1000)


def test_a_call_that_does_not_add_up_is_left_out(drained):
    drained["spans"], run = cut_run(extra=True)
    got = program_spans.state_device_ms(run)
    assert got == pytest.approx({"value": 44 / 1000, "calls_read": 1 / 3})


def test_a_window_of_synced_calls_only_reads_nothing(drained):
    spans, run = cut_run()
    for s in spans[4:]:                 # the later call synced too
        s.synced = True
    drained["spans"] = spans
    assert program_spans.state_device_ms(run) is None
    assert program_spans.entry_self_host_ms(run)["device_unread"] == \
        "no call after the synced ones"


def test_call_starts_follow_a_drifting_clock():
    """300 calls of three operations, the trace's clock drifting 1 µs a
    call against the host's (300 µs in all) and jumping 150 µs halfway;
    within a call the device idles longer than between two calls' host
    times, but not longer than the host's wait for a call's first
    operation."""
    n, first = 300, 2
    t0 = np.arange(n, dtype=np.int64) * 1000 * US
    t_ready = t0 + 500 * US
    err = np.arange(n) * US + np.where(np.arange(n) >= n // 2, 150 * US, 0)
    starts, ends = [], []
    for i in range(n):                      # host 0-500 µs a call
        for s, e in ((120, 200), (260, 380), (390, 470)):
            starts.append(t0[i] + s * US + err[i])
            ends.append(t0[i] + e * US + err[i])
    got = program_spans.call_starts(np.asarray(starts), np.asarray(ends),
                                    t0, t_ready, first)
    assert got == [3 * i for i in range(first, n)]


def test_a_synced_calls_stretches_end_in_the_middle_of_its_gaps():
    spans, _ = cut_run()
    plain, first = program_spans.stretches(spans[:4])
    times, owners = program_spans.stretches(spans[:4], gap=2 * US)
    assert owners == first
    assert times == [t - US for t in plain]

"""The span recorder (``repro_torch.spans``) and the spans of the
estimation path: nothing records outside a ``torch.profiler`` session;
``impl='cuda'`` (the kernels' plain versions on CPU tensors) gives each
call one tree of ``state``, ``features``, ``pack``, ``charge`` and
``report`` spans under its root, with the state and charge kernels'
launches;
the recorder's own work lies in no span; recording changes no report
bit."""
import pathlib
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import device_sim, fleet, model_api, traces
from repro_torch.core.estimate_batch import TraceBatch
from repro_torch.kernels.vampire_energy import ops as vops

MODEL = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
         / "data" / "vampire_quickfit_v2.npz")


def recording():
    """A profiler session on this thread: the spans record inside it."""
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def empty_buffer():
    spans.drain()
    yield
    spans.drain()


@pytest.fixture(scope="module")
def model():
    return model_api.load_estimator(str(MODEL), device="cpu")


@pytest.fixture(scope="module")
def batch():
    trs = [traces.app_trace(traces.SPEC_APPS[i], n_requests=n)
           for i, n in ((0, 40), (4, 60), (2, 25))]
    return TraceBatch.from_traces(trs)


@pytest.fixture(scope="module")
def stacked():
    return device_sim.synth_fleet_params(11, device="cpu")[1]


def _tree(got):
    """(root, the root's children in order) of one call's spans."""
    roots = [s for s in got if s.parent is None]
    assert len(roots) == 1
    root = roots[0]
    assert all(s.root == root.id for s in got)
    by_id = {s.id: s for s in got}
    for s in got:
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    kids = sorted((s for s in got if s.parent == root.id),
                  key=lambda s: s.start_ns)
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    return root, kids


def test_nothing_records_by_default_or_after_recording(model, batch):
    model.estimate(batch, mode="mean", impl="cuda")
    assert spans.drain() == []
    with recording():
        model.estimate(batch, mode="mean", impl="cuda")
    assert spans.drain()
    model.estimate(batch, mode="mean", impl="cuda")
    assert spans.drain() == []
    assert spans.span("state") is spans.span("pack", launches=len)


def test_drain_empties_the_buffer_and_keeps_open_spans_out():
    with recording():
        with spans.span("outer"):
            with spans.span("inner"):
                pass
            assert [s.name for s in spans.drain()] == ["inner"]
        got = spans.drain()
    assert [s.name for s in got] == ["outer"]
    assert got[0].synced is False              # no CUDA here
    assert spans.drain() == []


@pytest.mark.parametrize("mode,kids", [
    ("mean", ["state", "features", "pack", "charge", "report", "report"]),
    ("surface", ["state", "features", "pack", "charge", "report"]),
])
def test_an_estimate_is_one_tree_with_the_counts(model, batch, mode, kids):
    with recording():
        model.estimate(batch, mode=mode, impl="cuda")
        model.estimate(batch, mode=mode, impl="cuda")
    got = spans.drain()
    first = [s for s in got if s.root == got[0].root]
    assert len(first) * 2 == len(got)
    root, children = _tree(first)
    assert root.name == "estimate" and root.counts == {}
    assert [s.name for s in children] == kids
    assert [s.counts for s in children] == [
        {"launches": 0} if s.name in ("state", "charge") else {}  # CPU
        for s in children]
    # the parameter blocks: the one span inside charge
    charge = children[kids.index("charge")]
    assert [s.name for s in got if s.parent == charge.id] == ["pack"]


@pytest.mark.parametrize("chunk", [1, 4, 11])
def test_a_chunked_map_spans_each_module_chunk(stacked, batch, chunk):
    n_chunks = -(-11 // chunk)
    with recording():
        fleet.fleet_surface_energy(stacked, batch.trace, batch.weight,
                                   impl="cuda", module_chunk=chunk)
    got = spans.drain()
    root, children = _tree(got)
    assert root.name == "fleet_map"
    names = [s.name for s in children]
    assert names == (["pack", "state", "features", "pack"]
                     + ["charge"] * n_chunks + ["report"])
    charges = children[4:-1]
    assert all(s.counts == {"launches": 0} for s in charges)
    # each chunk's parameter blocks: the one span inside its charge span
    for c in charges:
        assert [s.name for s in got if s.parent == c.id] == ["pack"]


def test_a_count_is_its_change(monkeypatch):
    monkeypatch.setattr(vops.vampire_charge, "launches",
                        vops.vampire_charge.launches)
    with recording():
        with spans.span("charge", launches=vops.charge_launches):
            vops.vampire_charge.launches += 2
        with spans.span("charge", launches=vops.charge_launches):
            pass
    assert [s.counts for s in spans.drain()] == [{"launches": 2},
                                                 {"launches": 0}]


def test_a_span_inside_one_of_its_name_is_its_child():
    with recording():
        with spans.span("charge"):
            with spans.span("charge"):
                pass
    inner, outer = spans.drain()
    assert (inner.name, outer.name) == ("charge", "charge")
    assert inner.parent == outer.id and outer.parent is None


def test_the_buffer_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(spans, "_finished",
                        spans.collections.deque(maxlen=3))
    with recording():
        for k in range(5):
            with spans.span(f"s{k}"):
                pass
    assert [s.name for s in spans.drain()] == ["s2", "s3", "s4"]


def test_a_span_left_by_an_exception_still_ends():
    with recording():
        with pytest.raises(ValueError):
            with spans.span("outer"):
                with spans.span("inner"):
                    raise ValueError("no")
        with spans.span("next"):
            pass
    got = spans.drain()
    assert [s.name for s in got] == ["inner", "outer", "next"]
    assert got[2].parent is None and got[2].root == got[2].id


def test_a_profiler_session_records_and_its_end_stops(model, batch):
    with profile(activities=[ProfilerActivity.CPU]):
        model.estimate(batch, mode="surface", impl="cuda")
    got = spans.drain()
    assert [s.name for s in got][-1] == "estimate" and len(got) == 7
    model.estimate(batch, mode="surface", impl="cuda")
    assert spans.drain() == []


@pytest.mark.parametrize("call", ["mean", "surface", "map"])
def test_recording_changes_no_report_bit(model, batch, stacked, call):
    def run():
        if call == "map":
            return fleet.fleet_surface_energy(stacked, batch.trace,
                                              batch.weight, impl="cuda",
                                              module_chunk=4)
        return model.estimate(batch, mode=call, impl="cuda")

    off = run()
    with recording():
        on = run()
    assert spans.drain()
    for name, a, b in zip(off._fields, off, on):
        assert torch.equal(a, b), name


@pytest.fixture
def fake_card(monkeypatch):
    """CUDA reads as initialised; each synchronise is counted and takes
    ``waits["s"]`` seconds of the host's time."""
    waits = {"n": 0, "s": 0.0}

    def synchronize():
        waits["n"] += 1
        time.sleep(waits["s"])

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    return waits


def test_the_first_roots_after_a_drain_are_synced(fake_card):
    def call():
        with spans.span("root"):
            with spans.span("state"):
                pass

    with recording():
        for _ in range(spans.SYNCED_ROOTS + 2):
            call()
        got = spans.drain()
        call()
    roots = [s for s in got if s.parent is None]
    assert [s.synced for s in roots] == ([True] * spans.SYNCED_ROOTS
                                         + [False, False])
    assert all(s.synced == roots[(i // 2)].synced
               for i, s in enumerate(got))      # a child as its root
    assert fake_card["n"] == 4 * spans.SYNCED_ROOTS + 4   # two an edge
    assert all(s.synced for s in spans.drain())    # after the drain


def test_the_recorders_own_time_lies_in_no_span(fake_card):
    """Waits of 20 ms at each edge of a synced span fall outside every
    span: the root's time less its child's outer interval is its own
    work."""
    fake_card["s"] = 0.02
    with recording():
        with spans.span("root"):
            time.sleep(0.01)
            with spans.span("state"):
                pass
    state, root = spans.drain()
    assert state.synced and root.synced
    assert state.end_ns - state.start_ns < 10_000_000
    assert state.outer_end_ns - state.outer_start_ns >= 40_000_000
    own = (root.end_ns - root.start_ns) - (state.outer_end_ns
                                           - state.outer_start_ns)
    assert 10_000_000 <= own < 20_000_000
    assert root.start_ns - root.outer_start_ns >= 20_000_000


def test_threads_keep_their_own_trees(monkeypatch):
    """Eight threads nest spans at once (a short switch interval): every
    span lands in the buffer once, under its own thread's root."""
    per, n_threads = 200, 8
    # a profiler session records on its own thread: say one runs on each
    monkeypatch.setattr(spans, "_profiling", lambda: True)

    def work(k):
        for _ in range(per):
            with spans.span(f"root{k}"):
                with spans.span(f"child{k}"):
                    pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    got = spans.drain()
    assert len(got) == 2 * per * n_threads
    roots = {s.id: s for s in got if s.parent is None}
    for s in got:
        if s.name.startswith("child"):
            up = roots[s.parent]
            assert up.name == "root" + s.name[5:] and s.root == up.id

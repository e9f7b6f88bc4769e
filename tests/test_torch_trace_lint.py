"""The port's protocol linter against the reference's: the numpy engine
(``lint_trace``) and the per-command walk (``reference_lint``) give the
same ``(rule, severity, cmd_index, bank, margin)`` diagnostics as
``repro.analysis.trace_lint`` on the seeded broken streams of
``tests/test_analysis.py`` (one per rule), on seeded random streams and on
generated traces; ``check_generated`` raises where the reference's does;
and the batched torch engine (``lint_traces`` / ``lint_batch`` /
``lint_ingested``) gives the reference's batched diagnostics, trace index
included, on ragged batches of those streams."""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import trace_lint as rlint
from repro.core import dram as rdram
from repro.core import idd_loops
from repro.core import traces as rtraces
from repro_torch.analysis import trace_lint as plint
from repro_torch.core import dram as pdram
from repro_torch.core import traces as ptraces
from repro_torch.core.dram import (ACT, NOP, PDE, PDE_SLOW, PDX, PRE, PREA,
                                   RD, REF, SRE, SRX, TIMING, WR)

T = TIMING

# one minimal illegal stream per rule: (cmd, bank, dt) triples, the
# command index and the bank the diagnostic must name
SEEDED = {
    "tRCD": ([(ACT, 0, T.tRCD - 1), (RD, 0, 1)], 1, 0),
    "tRP": ([(ACT, 0, T.tRAS + 2), (PRE, 0, T.tRP - 1), (ACT, 0, 1)], 2, 0),
    "tRAS": ([(ACT, 0, T.tRAS - 1), (PRE, 0, 1)], 1, 0),
    "tRC": ([(ACT, 0, T.tRAS), (PRE, 0, T.tRP - 1), (ACT, 0, 1)], 2, 0),
    "tRRD": ([(ACT, 0, T.tRRD - 1), (ACT, 1, 1)], 1, 1),
    "tFAW": ([(ACT, 0, T.tRRD), (ACT, 1, T.tRRD), (ACT, 2, T.tRRD),
              (ACT, 3, T.tRRD - 1), (ACT, 4, 1)], 4, 4),
    "tWR": ([(ACT, 0, T.tRCD), (WR, 0, T.tBURST + T.tWR - 1),
             (PRE, 0, 1)], 2, 0),
    "tRTP": ([(ACT, 0, T.tRAS - T.tRTP + 1), (RD, 0, T.tRTP - 1),
              (PRE, 0, 1)], 2, 0),
    "tWTR": ([(ACT, 0, T.tRCD), (WR, 0, T.tBURST + T.tWTR - 1),
              (RD, 0, 1)], 2, 0),
    "tCCD": ([(ACT, 0, T.tRCD), (RD, 0, T.tCCD - 1), (RD, 0, 1)], 2, 0),
    "tRFC": ([(REF, 0, T.tRFC - 1), (ACT, 0, 1)], 1, 0),
    "tXP": ([(PDE, 0, T.tCKE), (PDX, 0, T.tXP - 1), (ACT, 0, 1)], 2, 0),
    "tXPDLL": ([(PDE_SLOW, 0, T.tCKE), (PDX, 0, T.tXPDLL - T.tRCD - 1),
                (ACT, 0, T.tRCD), (RD, 0, 1)], 3, 0),
    "tXS": ([(SRE, 0, T.tCKE), (SRX, 0, T.tXS - 1), (ACT, 0, 1)], 2, 0),
    "BANK_RW_CLOSED": ([(RD, 2, 1)], 0, 2),
    "BANK_ACT_OPEN": ([(ACT, 0, T.tRC), (ACT, 0, 1)], 1, 0),
    "REF_BANK_OPEN": ([(ACT, 0, T.tRAS), (REF, 0, 1)], 1, 0),
    "PDN_ILLEGAL_CMD": ([(PDE, 0, T.tCKE), (ACT, 0, 1)], 1, 0),
    "SR_ILLEGAL_CMD": ([(SRE, 0, T.tCKE), (ACT, 0, 1)], 1, 0),
    "DT_NEGATIVE": ([(NOP, 0, -1)], 0, 0),
    "tREFI": ([(NOP, 0, T.tREFI + rlint.REFI_SLACK + 10), (REF, 0, 1)],
              1, 0),
}


def raw_pair(script):
    """The same (cmd, bank, dt) stream as a reference trace and as a port
    trace, built WITHOUT the low-power validation (the linter is the
    system under test; it must see illegal streams)."""
    cmd, bank, dt = (np.array(c, np.int32) for c in zip(*script))
    n = len(cmd)
    z = np.zeros(n, np.int32)
    ref = rdram.CommandTrace(jnp.asarray(cmd), jnp.asarray(bank),
                             jnp.asarray(z), jnp.asarray(z),
                             jnp.zeros((n, 16), jnp.uint32), jnp.asarray(dt))
    zt = torch.zeros(n, dtype=torch.int32)
    port = pdram.CommandTrace(torch.from_numpy(cmd), torch.from_numpy(bank),
                              zt, zt, torch.zeros((n, 16), dtype=torch.int32),
                              torch.from_numpy(dt))
    return ref, port


def key(diags):
    return sorted((d.rule, d.severity, d.trace_index, d.cmd_index, d.bank,
                   d.margin) for d in diags)


def assert_engines_agree(ref_tr, port_tr):
    want = key(rlint.lint_trace(ref_tr))
    assert key(rlint.reference_lint(ref_tr)) == want
    assert key(plint.lint_trace(port_tr)) == want
    assert key(plint.reference_lint(port_tr)) == want
    return want


def test_rule_registry_matches_reference():
    assert tuple(plint.RULES) == tuple(rlint.RULES)
    for rid, r in rlint.RULES.items():
        p = plint.RULES[rid]
        assert (p.severity, p.description) == (r.severity, r.description)
    assert plint.REFI_SLACK == rlint.REFI_SLACK


@pytest.mark.parametrize("rule_id", sorted(SEEDED))
def test_seeded_broken_stream_gives_the_reference_diagnostics(rule_id):
    script, idx, bank = SEEDED[rule_id]
    ref_tr, port_tr = raw_pair(script)
    diags = assert_engines_agree(ref_tr, port_tr)
    assert (rule_id, plint.RULES[rule_id].severity, 0, idx, bank) in \
        {d[:5] for d in diags}
    msgs = [d.message for d in plint.lint_trace(port_tr)]
    assert msgs == [d.message for d in rlint.lint_trace(ref_tr)]


_CMDS = (NOP, ACT, PRE, RD, WR, REF, PDE, PDX, PREA, PDE_SLOW, SRE, SRX)


@pytest.mark.parametrize("seed", range(4))
def test_engines_agree_on_seeded_random_streams(seed):
    rng = np.random.default_rng([31, seed])
    fired = 0
    for _ in range(60):
        n = int(rng.integers(1, 41))
        script = list(zip(rng.choice(_CMDS, n).tolist(),
                          rng.integers(0, 8, n).tolist(),
                          rng.integers(0, 2 * T.tRC + 1, n).tolist()))
        fired += len(assert_engines_agree(*raw_pair(script)))
    assert fired > 0


def test_generated_traces_lint_clean_in_both_packages():
    for i, n in ((0, 300), (7, 600), (3, 400)):
        ref_tr = rtraces.app_trace(rtraces.SPEC_APPS[i], n_requests=n)
        port_tr = ptraces.app_trace(ptraces.SPEC_APPS[i], n_requests=n)
        assert assert_engines_agree(ref_tr, port_tr) == []
    idd = idd_loops.idd7(reps=2)
    assert plint.lint_trace(pdram.make_trace(
        *[np.asarray(f) for f in idd])) == []


@pytest.mark.parametrize("rule_id", ["tRAS", "tRCD", "SR_ILLEGAL_CMD"])
def test_check_generated_raises_where_the_reference_does(rule_id,
                                                         monkeypatch):
    monkeypatch.delenv("REPRO_TRACE_LINT", raising=False)
    ref_tr, port_tr = raw_pair(SEEDED[rule_id][0])
    with pytest.raises(rlint.TraceProtocolError) as r_err:
        rlint.check_generated(ref_tr, "test")
    with pytest.raises(plint.TraceProtocolError) as p_err:
        plint.check_generated(port_tr, "test")
    assert isinstance(p_err.value, ValueError)
    assert p_err.value.origin == "test"
    assert key(p_err.value.diagnostics) == key(r_err.value.diagnostics)
    assert str(p_err.value) == str(r_err.value)
    monkeypatch.setenv("REPRO_TRACE_LINT", "off")
    assert plint.check_generated(port_tr, "test") is port_tr


def test_check_generated_warns_on_a_late_refresh(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE_LINT", raising=False)
    _, port_tr = raw_pair(SEEDED["tREFI"][0])
    with pytest.warns(UserWarning, match=r"\[test\] tREFI"):
        assert plint.check_generated(port_tr, "test") is port_tr


def test_make_trace_hook_is_opt_in(monkeypatch):
    cmds, banks, dts = zip(*SEEDED["tRCD"][0])
    monkeypatch.delenv("REPRO_TRACE_LINT", raising=False)
    pdram.make_trace(list(cmds), list(banks), dts=list(dts))  # off
    monkeypatch.setenv("REPRO_TRACE_LINT", "warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pdram.make_trace(list(cmds), list(banks), dts=list(dts))
    assert any("tRCD" in str(w.message) for w in caught)
    monkeypatch.setenv("REPRO_TRACE_LINT", "strict")
    with pytest.raises(plint.TraceProtocolError):
        pdram.make_trace(list(cmds), list(banks), dts=list(dts))


def test_builder_lints_when_given_an_origin(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE_LINT", raising=False)
    bld = ptraces.TraceBuilder()
    bld.cmds, bld.banks, bld.rows, bld.cols = [RD], [2], [0], [0]
    bld.datas, bld.dts = [None], [1]          # a RD to a closed bank
    assert bld.build().n == 1                 # no origin: no lint
    with pytest.raises(plint.TraceProtocolError, match="unit-test"):
        bld.build("unit-test")


# ---------------------------------------------------------------------------
# The batched engine (serving admission)
# ---------------------------------------------------------------------------
def batch_key(diags):
    return sorted((d.trace_index, d.rule, d.severity, d.cmd_index, d.bank,
                   d.margin) for d in diags)


def test_batched_lint_of_the_seeded_streams_matches_the_reference():
    pairs = [raw_pair(SEEDED[rid][0]) for rid in sorted(SEEDED)]
    ref_trs, port_trs = zip(*pairs)
    want = batch_key(rlint.lint_traces(ref_trs))
    assert batch_key(plint.lint_traces(port_trs)) == want
    # each trace alone, as trace 0
    for ti, (r, p) in enumerate(pairs):
        single = [d for d in want if d[0] == ti]
        assert [(0,) + d[1:] for d in single] == \
            batch_key(plint.lint_traces([p]))
    msgs = [d.message for d in plint.lint_traces(port_trs)]
    assert sorted(msgs) == sorted(d.message
                                  for d in rlint.lint_traces(ref_trs))


@pytest.mark.parametrize("seed", range(3))
def test_batched_lint_of_ragged_random_batches(seed):
    rng = np.random.default_rng([37, seed])
    ref_trs, port_trs = [], []
    for _ in range(int(rng.integers(3, 9))):
        n = int(rng.integers(1, 70))
        script = list(zip(rng.choice(_CMDS, n).tolist(),
                          rng.integers(0, 8, n).tolist(),
                          rng.integers(0, 2 * T.tRC + 1, n).tolist()))
        r, p = raw_pair(script)
        ref_trs.append(r)
        port_trs.append(p)
    want = batch_key(rlint.lint_traces(ref_trs))
    assert want
    assert batch_key(plint.lint_traces(port_trs)) == want
    # the same batch through lint_batch on a prebuilt TraceBatch
    from repro_torch.core.estimate_batch import as_trace_batch
    assert batch_key(plint.lint_batch(as_trace_batch(port_trs))) == want


def test_batched_lint_of_generated_traces_is_clean():
    trs = [ptraces.app_trace(ptraces.SPEC_APPS[i], n_requests=n)
           for i, n in ((0, 300), (7, 600), (3, 40))]
    assert plint.lint_traces(trs) == []
    assert plint.lint_traces([]) == []


def test_lint_ingested_raises_with_structured_diagnostics():
    good = pdram.make_trace(*[np.asarray(f)
                              for f in idd_loops.idd0(reps=2)])
    _, corrupt = raw_pair(SEEDED["tRCD"][0])
    plint.lint_ingested([good])
    with pytest.raises(plint.TraceProtocolError) as ei:
        plint.lint_ingested([good, corrupt], origin="serve.power_report")
    (d,) = ei.value.diagnostics
    assert (d.rule, d.trace_index, d.cmd_index, d.bank) == ("tRCD", 1, 1, 0)
    assert ei.value.origin == "serve.power_report" and "tRCD" in str(ei.value)

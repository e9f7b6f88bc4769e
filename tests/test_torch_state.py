"""The state kernel's plain version (``batched_state``: ``structural_state``
and ``pack_state``) against the reference's own ``structural_state``,
packed the same way, and its previous RD/WR, on seeded traces at the
edges of the state machine; and the ``impl='cuda'`` assemblers that now
take their state word from it (``charge_planes`` in distribution mode,
``baseline_charge_matrix``) against the composition they replaced."""
import jax
import numpy as np
import pytest
import torch

from repro.core import dram as rdram
from repro.core import estimate_batch as rbatch
from repro.core.energy_model import structural_state as r_state
from repro_torch.core import dram as pdram
from repro_torch.core import estimate_batch as pbatch
from repro_torch.core.baselines_power import BASELINE_IDD_KEYS
from repro_torch.core.energy_model import structural_state
from repro_torch.kernels.baseline_energy import baseline_energy as p_be
from repro_torch.kernels.baseline_energy import ops as p_bops
from repro_torch.kernels.vampire_energy import ops as p_vops
from repro_torch.kernels.vampire_energy import vampire_energy as p_ve

NOP, ACT, PRE, RD, WR, REF = (rdram.NOP, rdram.ACT, rdram.PRE, rdram.RD,
                              rdram.WR, rdram.REF)
PDE, PDX, PREA, PDS, SRE, SRX = (rdram.PDE, rdram.PDX, rdram.PREA,
                                 rdram.PDE_SLOW, rdram.SRE, rdram.SRX)
ALL_CODES = (NOP, ACT, PRE, RD, WR, REF, PDE, PDX, PREA, PDS, SRE, SRX)
_r_batch_state = jax.jit(jax.vmap(r_state))


def _raw(cmd, bank, col) -> rdram.CommandTrace:
    """A reference trace from ``(N,)`` fields as they are (no transition
    check: the state machine takes any stream).  Line ``i`` carries
    ``i + 1`` in its first word, so the reference's ``prev_data`` names
    the previous RD/WR's index."""
    cmd = np.asarray(cmd, np.int32)
    n = cmd.shape[0]
    data = np.zeros((n, 16), np.uint32)
    data[:, 0] = np.arange(1, n + 1)
    return rdram.CommandTrace(cmd, np.asarray(bank, np.int32),
                              np.zeros(n, np.int32), np.asarray(col, np.int32),
                              data, np.ones(n, np.int32))


def _random(rng, n, codes=ALL_CODES, cols=4):
    return _raw(rng.choice(codes, n), rng.integers(0, 8, n),
                rng.integers(0, cols, n))


def _scripted(cmds, rng, cols=128):
    """``cmds`` as ``(code, bank)`` pairs or bare codes (bank 0), seeded
    columns."""
    pairs = [c if isinstance(c, tuple) else (c, 0) for c in cmds]
    return _raw([c for c, _ in pairs], [b for _, b in pairs],
                rng.integers(0, cols, len(pairs)))


def _case(name: str):
    """(reference traces, slots, padded length) of each edge case."""
    rng = np.random.default_rng(CASES.index(name) + 71)
    if name == "ragged":
        # unequal lengths NOP-padded into a bucket, a length-1 trace and a
        # pad row
        return [_random(rng, n) for n in (37, 1, 300, 5, 129)], 6, 320
    if name == "length_one":
        return [_scripted([c], rng) for c in (RD, ACT, NOP)], 3, 1
    if name == "no_rw":
        return [_scripted([(ACT, 3), (PRE, 3), NOP, (ACT, 5), PDE, PDX,
                           PREA, REF] * 6, rng),
                _random(rng, 50, (NOP, ACT, PRE, REF, PREA, PDE, PDX))], 2, 64
    if name == "rw_first":
        return [_scripted([(RD, 2), (WR, 2), (ACT, 1), (RD, 1), PRE, WR,
                           NOP, RD], rng, cols=2),
                _scripted([(WR, k % 3) for k in range(9)], rng, cols=2)], 2, 16
    if name == "prea":
        return [_scripted([(ACT, b) for b in range(8)] + [PREA, (ACT, 4),
                          (RD, 4), (PRE, 4), (ACT, 6), PREA, PREA, (ACT, 0),
                          (PRE, 1), (WR, 0)], rng),
                _random(rng, 200, (ACT, PRE, PREA, RD, WR, NOP))], 2, 200
    if name == "power_down":
        # fast entry with banks open (active power-down) and closed, slow
        # entry, entries without an exit, exits without an entry
        return [_scripted([(ACT, 2), PDE, NOP, PDX, (RD, 2), (PRE, 2), PDE,
                           PDX, PDS, NOP, PDX, (ACT, 7), PDS, PDX, PDE, PDE,
                           PDS, PDX, PDX, (ACT, 1), PDE], rng),
                _scripted([PDX, PDS, PDE, (ACT, 3), PDE, (PRE, 3), PDX],
                          rng),
                _random(rng, 150, (ACT, PRE, RD, WR, PDE, PDS, PDX, NOP))
                ], 3, 150
    if name == "self_refresh":
        # self-refresh with banks open and closed, inside a power-down,
        # entries without an exit
        return [_scripted([(ACT, 0), SRE, NOP, SRX, (PRE, 0), SRE, SRX, PDE,
                           SRE, PDX, SRX, SRE, SRE, SRX, SRX, (ACT, 5), SRE,
                           PDS, SRX, PDX], rng),
                _random(rng, 150, (ACT, PRE, RD, SRE, SRX, PDE, PDX, NOP))
                ], 2, 150
    if name == "interleave":
        # RD/WR across and within banks on two columns: every mode
        return [_raw(rng.choice([RD, WR], 300), rng.integers(0, 3, 300),
                     rng.integers(0, 2, 300)),
                _raw(rng.choice([RD, WR, ACT, NOP], 300),
                     rng.integers(0, 8, 300), rng.integers(0, 3, 300))], 2, 300
    if name == "longer_than_a_tile":
        # past the kernel's 2,048- and 8,192-command tiles
        return [_random(rng, 8193), _random(rng, 5000, cols=128)], 3, 8200
    return [_random(rng, n) for n in (1000, 999, 64)], 3, 1000


CASES = ("ragged", "length_one", "no_rw", "rw_first", "prea", "power_down",
         "self_refresh", "interleave", "longer_than_a_tile", "random")


def _bridge(tr):
    return pdram.CommandTrace(*[torch.from_numpy(np.asarray(f).astype(
        np.int32)) for f in tr])


def _batches(name):
    trs, slots, length = _case(name)
    return (rbatch.bucketed_trace_batch(trs, slots, length),
            pbatch.bucketed_trace_batch([_bridge(t) for t in trs], slots,
                                        length))


def _reference_words(trace: rdram.CommandTrace):
    """The reference's ``structural_state`` of a ``(T, N)`` batch, packed
    as ``pack_state`` packs it, and the previous RD/WR's index (from the
    index each line carries; -1 where there is none)."""
    st = _r_batch_state(trace)
    mask = (np.asarray(st.open_before, np.int32) << np.arange(8)).sum(-1)
    word = (np.asarray(st.il_mode) | np.asarray(st.bg_state) << 2
            | mask << 8)
    prev = np.where(np.asarray(st.has_prev),
                    np.asarray(st.prev_data)[..., 0].astype(np.int64) - 1, -1)
    return prev, word


@pytest.mark.parametrize("name", CASES)
def test_state_plain_matches_the_reference(name):
    rtb, ptb = _batches(name)
    want_prev, want_word = _reference_words(rtb.trace)
    tr = ptb.trace
    before = p_ve.batched_state.launches
    prev, word = p_ve.batched_state(tr.cmd, tr.bank, tr.col)
    assert p_ve.batched_state.launches == before       # CPU: no launch
    assert prev.dtype == word.dtype == torch.int32
    assert prev.shape == word.shape == tr.cmd.shape
    np.testing.assert_array_equal(prev.numpy(), want_prev)
    np.testing.assert_array_equal(word.numpy(), want_word)
    # the wrapper's plain version is structural_state's prev_rw and
    # pack_state's word of it
    st = structural_state(tr)
    assert torch.equal(prev, st.prev_rw)
    assert torch.equal(word, p_vops.pack_state(st))
    if name == "power_down":
        bg = (word[0] >> 2) & 7
        assert {int(b) for b in bg} == {0, 1, 2, 3}
    if name == "self_refresh":
        assert bool((((word[0] >> 2) & 7) == 4).any())
    if name == "interleave":
        assert {int(m) for m in word[0] & 3} == {0, 1, 2, 3}


def _parent_distribution_planes(trace, weight, ones_frac, toggle_frac):
    """``charge_planes`` in distribution mode as it was before the state
    kernel: ``structural_state``'s flags and ``pack_state``'s word."""
    st = structural_state(trace)
    t = trace.cmd.shape[0]
    of = torch.as_tensor(ones_frac, dtype=torch.float32).expand(t)[:, None]
    tf = torch.as_tensor(toggle_frac, dtype=torch.float32).expand(t)[:, None]
    ones = torch.where(st.is_rw, of * pdram.LINE_BITS, 0.0)
    togg = torch.where(st.is_rw & st.has_prev, tf * pdram.LINE_BITS, 0.0)
    return (ones, togg, trace.cmd, trace.bank, trace.row, trace.dt,
            p_vops.pack_state(st), weight.to(torch.float32))


@pytest.mark.parametrize("fracs", [(0.35, 0.15), "per_trace"])
@pytest.mark.parametrize("name", ("ragged", "rw_first", "power_down"))
def test_distribution_planes_are_the_parent_composition(name, fracs):
    _, ptb = _batches(name)
    t = ptb.trace.cmd.shape[0]
    if fracs == "per_trace":
        fracs = (torch.linspace(0.1, 0.9, t), torch.linspace(0.4, 0.05, t))
    got = p_vops.charge_planes(ptb.trace, ptb.weight, ones_frac=fracs[0],
                               toggle_frac=fracs[1])
    want = _parent_distribution_planes(ptb.trace, ptb.weight, *fracs)
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i


@pytest.mark.parametrize("kind", p_be.KINDS)
@pytest.mark.parametrize("surface", [False, True])
def test_baseline_charge_matrix_takes_the_same_word(kind, surface):
    _, ptb = _batches("power_down")
    tr = ptb.trace
    table = torch.linspace(20.0, 120.0, 2 * len(BASELINE_IDD_KEYS)).reshape(
        2, -1)
    charge, _ = p_bops.baseline_charge_matrix(tr, ptb.weight, table, kind,
                                              surface=surface)
    want = p_be.WRAPPERS[kind, surface](
        tr.cmd, tr.bank, tr.row, tr.dt,
        p_vops.pack_state(structural_state(tr)), ptb.weight,
        (tr.cmd == pdram.ACT).any(-1).float(), table)
    assert torch.equal(charge.reshape(want.shape), want)


"""The feature kernel's plain version (``batched_features``: the previous
RD/WR's line gathered from ``prev_rw``) against the reference's Pallas
kernel run in interpret mode on the previous line and toggle mask that
the reference's own ``structural_state`` makes, bit for bit, on seeded
traces at the edges of that gather; and ``ops.charge_planes`` against
the composition it replaced (``prev_lines``, a float mask and the
feature pass on the materialised previous line), plane by plane."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dram as rdram
from repro.core import estimate_batch as rbatch
from repro.core import traces as rtraces
from repro.core.energy_model import structural_state as r_state
from repro.kernels.vampire_energy import vampire_energy as r_ve
from repro_torch.core import dram as pdram
from repro_torch.core import estimate_batch as pbatch
from repro_torch.core.dram import popcount_u32
from repro_torch.core.energy_model import prev_lines, structural_state
from repro_torch.kernels.vampire_energy import ops as p_vops
from repro_torch.kernels.vampire_energy import vampire_energy as p_ve

CODES = (rdram.NOP, rdram.ACT, rdram.PRE, rdram.RD, rdram.WR, rdram.REF)


def _trace(rng, cmds):
    """A reference trace of ``cmds`` with seeded addresses, data and
    cycle counts."""
    n = len(cmds)
    return rdram.make_trace(
        list(cmds), rng.integers(0, 8, n), rng.integers(0, 1 << 15, n),
        rng.integers(0, 128, n),
        rng.integers(0, 1 << 32, (n, 16), dtype=np.uint64).astype(np.uint32),
        rng.integers(1, 20, n))


def _random(rng, n):
    return _trace(rng, rng.choice(CODES, n, p=(.1, .2, .1, .3, .2, .1)))


def _bridge(tr):
    return pdram.make_trace(*[np.asarray(f) for f in tr])


def _case(name: str):
    """(reference traces, slots, padded length) of each edge case."""
    rng = np.random.default_rng(CASES.index(name) + 31)
    R, W, A, P, N = rdram.RD, rdram.WR, rdram.ACT, rdram.PRE, rdram.NOP
    if name == "ragged":
        # traces of unequal length NOP-padded into a bucket with a pad row
        return [_random(rng, n) for n in (37, 300, 5, 129)], 5, 320
    if name == "no_rw":
        return [_trace(rng, [A, P, N, A, P, rdram.REF] * 6),
                _random(rng, 50)], 2, 64
    if name == "rw_first":
        return [_trace(rng, [R, W, A, R, P, W, N, R]),
                _trace(rng, [W] * 9)], 2, 16
    # an RD/WR at index 0 that a late command's toggle reads back, and an
    # RD/WR at the last index of the padded batch (N - 1)
    n = 96
    return [_trace(rng, [R] + [A, P] * ((n - 2) // 2) + [W]),
            _trace(rng, [W] + [N] * (n - 2) + [R]),
            _random(rng, n)], 3, n


CASES = ("ragged", "no_rw", "rw_first", "prev_at_first_and_last")


def _batches(name):
    trs, slots, length = _case(name)
    return (rbatch.bucketed_trace_batch(trs, slots, length),
            pbatch.bucketed_trace_batch([_bridge(t) for t in trs], slots,
                                        length))


@pytest.mark.parametrize("name", CASES)
def test_features_match_pallas_on_the_references_previous_lines(name):
    rtb, ptb = _batches(name)
    t, n = ptb.trace.cmd.shape
    st = jax.vmap(r_state)(rtb.trace)
    r_ones, r_togg = r_ve.batched_features_pallas(
        rtb.trace.data.reshape(t * n, -1), st.prev_data.reshape(t * n, -1),
        (st.has_prev & st.is_rw).astype(jnp.float32).reshape(t * n),
        interpret=True)
    prev_rw = structural_state(ptb.trace).prev_rw
    assert prev_rw.dtype == torch.int32 and prev_rw.is_contiguous()
    before = p_ve.batched_features.launches
    ones, togg = p_ve.batched_features(ptb.trace.data, ptb.trace.cmd,
                                       prev_rw)
    assert p_ve.batched_features.launches == before   # CPU: no launch
    np.testing.assert_array_equal(ones.numpy().reshape(-1), np.asarray(r_ones))
    np.testing.assert_array_equal(togg.numpy().reshape(-1), np.asarray(r_togg))
    if name == "no_rw":
        assert not togg[0].any()
    if name == "prev_at_first_and_last":
        assert int(prev_rw[0, -1]) == 0 and int(prev_rw[1, -1]) == 0
        assert bool((togg[:2, -1] > 0).all())


def _parent_planes(trace, weight):
    """``charge_planes`` as it was before the gather moved into the
    kernel: ``prev_lines``, the float toggle mask and the feature pass on
    the materialised previous line."""
    st = structural_state(trace)
    tmask = (st.has_prev & st.is_rw).to(torch.float32)
    prev = prev_lines(trace.data, st)
    ones = popcount_u32(trace.data).sum(dim=-1).to(torch.float32)
    togg = popcount_u32(torch.bitwise_xor(trace.data, prev)).sum(dim=-1)
    return (ones, togg.to(torch.float32) * tmask, trace.cmd, trace.bank,
            trace.row, trace.dt, p_vops.pack_state(st),
            weight.to(torch.float32))


@pytest.mark.parametrize("name", CASES + ("apps",))
def test_charge_planes_are_the_parent_composition(name):
    if name == "apps":
        trs = [rtraces.app_trace(rtraces.SPEC_APPS[i], n_requests=k)
               for i, k in ((3, 80), (9, 140), (17, 60))]
        ptb = pbatch.bucketed_trace_batch([_bridge(t) for t in trs], 4, 1024)
    else:
        _, ptb = _batches(name)
    got = p_vops.charge_planes(ptb.trace, ptb.weight)
    want = _parent_planes(ptb.trace, ptb.weight)
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and torch.equal(g, w), i


def test_a_box_of_rows_gives_the_batchs_rows():
    """A sharded box is a row slice of the batch: it stays contiguous and
    its features are the batch's rows."""
    _, ptb = _batches("ragged")
    st = structural_state(ptb.trace)
    whole = p_ve.batched_features(ptb.trace.data, ptb.trace.cmd, st.prev_rw)
    rows = slice(1, 3)
    box = pdram.CommandTrace(*(x[rows] for x in ptb.trace))
    assert box.data.is_contiguous() and box.cmd.is_contiguous()
    got = p_ve.batched_features(box.data, box.cmd,
                                structural_state(box).prev_rw)
    for g, w in zip(got, whole):
        assert torch.equal(g, w[rows])

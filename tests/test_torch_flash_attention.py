"""The port's flash attention against the reference's: the plain version
(what the wrapper runs for CPU tensors) against ``flash_attention_pallas``
in interpret mode on the reference's own sweep, against ``attention_ref``
on ragged lengths the Pallas kernel refuses, and the model-level
``blockwise_attention`` against the reference's pure-jnp twin, also with
v narrower than q and k (MLA); the kernel's instances by widths.  Inputs are
seeded numpy arrays handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as rfa
from repro.kernels.flash_attention import ref as rref
from repro.models import layers as RL
from repro_torch.kernels.flash_attention import flash_attention as pfa
from repro_torch.kernels.flash_attention import ops as pops
from repro_torch.kernels.flash_attention import ref as pref
from repro_torch.models import layers as PL

# the reference's tolerances (tests/test_kernels.py)
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, *shapes, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jx = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    pt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, pt


def _close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,h,kh,d", [
    (256, 256, 4, 2, 32), (512, 512, 2, 2, 64), (256, 512, 8, 2, 16),
    (256, 256, 16, 2, 128)])     # the serving geometry (qwen2.5-3b's heads)
def test_plain_version_matches_pallas_kernel(dtype, sq, skv, h, kh, d):
    (q, k, v), (pq, pk, pv) = _inputs(
        sq + d, (h, sq, d), (kh, skv, d), (kh, skv, d), dtype=dtype)
    before = pfa.flash_attention.launches
    for causal in (True, False):
        if causal and sq != skv:
            continue
        want = rfa.flash_attention_pallas(q, k, v, causal=causal,
                                          block_q=128, block_k=128,
                                          interpret=True)
        got = pfa.flash_attention(pq, pk, pv, causal=causal)
        assert got.dtype == pq.dtype and got.shape == pq.shape
        _close(got, want, ATOL[dtype])
    assert pfa.flash_attention.launches == before      # no kernel on a CPU


@pytest.mark.parametrize("sq,skv,causal", [(40, 40, True), (200, 200, True),
                                           (40, 72, False), (200, 13, False),
                                           (37, 37, False)])
def test_ragged_lengths_match_attention_ref(sq, skv, causal):
    (q, k, v), (pq, pk, pv) = _inputs(sq * skv, (6, sq, 24), (3, skv, 24),
                                      (3, skv, 24))
    want = rref.attention_ref(q, k, v, causal=causal)
    _close(pfa.flash_attention(pq, pk, pv, causal=causal), want,
           ATOL["float32"])
    _close(pops.flash_attention(pq, pk, pv, causal=causal, use_kernel=False),
           want, ATOL["float32"])


def test_q_offset_shifts_the_causal_diagonal():
    """A query block at offset o sees the keys a full causal pass shows its
    rows: the last 8 rows of a 40-long causal attention."""
    _, (q, k, v) = _inputs(3, (4, 40, 16), (2, 40, 16), (2, 40, 16))
    full = pref.attention_ref(q, k, v, causal=True)
    tail = pfa.flash_attention(q[:, 32:].contiguous(), k, v, causal=True,
                               q_offset=32)
    torch.testing.assert_close(tail, full[:, 32:], atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="q_offset"):
        pfa.flash_attention(q, k, v, q_offset=-1)
    with pytest.raises(ValueError, match="multiple of kv rows"):
        pfa.flash_attention(q[:3], k, v)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kh,d,block", [
    (2, 40, 4, 2, 16, 32), (2, 256, 4, 2, 32, 64), (2, 256, 4, 2, 32, 32)])
def test_blockwise_attention_matches_reference(b, s, h, kh, d, block, causal):
    (q, k, v), (pq, pk, pv) = _inputs(s + block, (b, s, h, d), (b, s, kh, d),
                                      (b, s, kh, d))
    want = RL.blockwise_attention(q, k, v, causal=causal, block=block)
    got = PL.blockwise_attention(pq, pk, pv, causal=causal, block=block)
    assert got.shape == (b, s, h, d)
    _close(got, want, 3e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kh,d,dv,block", [
    (2, 40, 4, 4, 48, 32, 32),       # deepseek-v2-lite-16b's smoke MLA
    (2, 256, 4, 2, 48, 32, 64), (1, 70, 2, 2, 192, 128, 32)])
def test_blockwise_attention_with_narrower_values_matches_reference(
        b, s, h, kh, d, dv, block, causal):
    """MLA's shape: q and k ``d_nope + d_rope`` wide, v ``d_v`` wide; the
    output takes v's width."""
    (q, k, v), (pq, pk, pv) = _inputs(s + d + dv, (b, s, h, d),
                                      (b, s, kh, d), (b, s, kh, dv))
    want = RL.blockwise_attention(q, k, v, causal=causal, block=block)
    got = PL.blockwise_attention(pq, pk, pv, causal=causal, block=block)
    assert got.shape == want.shape == (b, s, h, dv)
    _close(got, want, 3e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,h,kh,d,dv", [
    (64, 64, 4, 4, 192, 128), (40, 72, 6, 3, 48, 32)])
def test_plain_version_takes_narrower_values(dtype, sq, skv, h, kh, d, dv):
    (q, k, v), (pq, pk, pv) = _inputs(sq + dv, (h, sq, d), (kh, skv, d),
                                      (kh, skv, dv), dtype=dtype)
    for causal in (True, False):
        if causal and sq != skv:
            continue
        want = rref.attention_ref(q, k, v, causal=causal)
        got = pfa.flash_attention(pq, pk, pv, causal=causal)
        assert got.shape == (h, sq, dv) and got.dtype == pq.dtype
        _close(got, want, ATOL[dtype])


@pytest.mark.parametrize("d,dv,dtype,takes", [
    (128, 128, torch.bfloat16, True), (64, 64, torch.bfloat16, True),
    (192, 128, torch.bfloat16, True),     # MLA
    (48, 32, torch.bfloat16, True),       # the (64, 64) instance, padded
    (160, 96, torch.bfloat16, True),      # the (192, 128) instance, padded
    (128, 64, torch.bfloat16, False), (192, 192, torch.bfloat16, False),
    (192, 64, torch.bfloat16, False), (256, 128, torch.bfloat16, False),
    (128, 128, torch.float32, True), (192, 128, torch.float32, True),
    (48, 32, torch.float32, True), (192, 136, torch.float32, False),
    (64, 128, torch.bfloat16, False), (30, 30, torch.bfloat16, False)])
def test_kernel_instances_by_widths(d, dv, dtype, takes):
    """Which (q/k, v) widths the kernel takes: on a card anything else
    raises rather than running the plain version."""
    assert pfa.kernel_takes(d, dv, dtype) is takes


def test_the_f7_guard_refuses_grad_inputs_under_grad_mode():
    """F7: the card's kernel has no backward, so its wrapper refuses an
    input that requires grad while grad mode is on (called directly here:
    CPU tensors take the plain version, which stays differentiable)."""
    q = torch.randn(2, 8, 16, requires_grad=True)
    k, v = torch.randn(2, 8, 16), torch.randn(2, 8, 16)
    for args in ((q, k, v), (k, q, v), (k, v, q)):
        with pytest.raises(RuntimeError, match="F7.*no backward"):
            pfa.refuse_grad(*args)
    with torch.no_grad():
        pfa.refuse_grad(q, k, v)
    pfa.refuse_grad(k, v, k)
    before = pfa.flash_attention.launches
    out = pfa.flash_attention(q, k, v)
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    assert pfa.flash_attention.launches == before

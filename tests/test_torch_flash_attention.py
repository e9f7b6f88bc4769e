"""The port's flash attention against the reference's: the plain version
(what the wrapper runs for CPU tensors) against ``flash_attention_pallas``
in interpret mode on the reference's own sweep, against ``attention_ref``
on ragged lengths the Pallas kernel refuses, and the model-level
``blockwise_attention`` against the reference's pure-jnp twin, also with
v narrower than q and k (MLA); the kernel's instances by widths; the
statistics the backward kernels read (the forward's lse against
``jax.nn.logsumexp``, K0's delta against ``rowsum(do * o)`` in JAX) and
``FlashAttention`` saving lse only when an input needs a gradient; and the
gradients of ``FlashAttention`` on CPU tensors (the plain backward, on the
forward's lse) against ``jax.vjp`` of the reference's blockwise attention,
``attention_bwd_ref`` given that lse against the same, the plain backward
against autograd through the plain forward, ``gradcheck`` in float64, and
the refusal of a backward at a q offset.  Inputs are seeded numpy arrays
handed to both packages."""
import jax
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


@pytest.mark.parametrize("b,sq,skv,h,kh,d,dv,causal", [
    (2, 40, 40, 4, 4, 16, 16, True),          # group 1, ragged (block 32)
    (2, 40, 40, 4, 2, 16, 16, False),         # group 2
    (1, 70, 70, 8, 1, 32, 32, True),          # group 8, ragged
    (2, 33, 50, 4, 2, 24, 24, False),         # cross: Sq != Skv
    (2, 40, 40, 4, 4, 48, 32, True),          # MLA's narrower values
    (1, 64, 64, 2, 2, 192, 128, False)])
def test_gradients_match_jax_grad_of_the_reference(b, sq, skv, h, kh, d, dv,
                                                   causal):
    """``FlashAttention`` on CPU tensors (the plain forward and
    ``attention_bwd_ref``) against ``jax.vjp`` of the reference's
    blockwise attention, the twin its train step differentiates, with one
    seeded cotangent: float32 at rtol 1e-5, atol 1e-6."""
    (q, k, v, do), (pq, pk, pv, pdo) = _inputs(
        sq * skv + d, (b, sq, h, d), (b, skv, kh, d), (b, skv, kh, dv),
        (b, sq, h, dv))
    out, vjp = jax.vjp(lambda *a: RL.blockwise_attention(
        *a, causal=causal, block=32), q, k, v)
    want = vjp(do)
    leaves = [t.clone().requires_grad_(True) for t in (pq, pk, pv)]
    got = PL.blockwise_attention(*leaves, causal=causal, block=32)
    before = pfa.flash_attention.launches, dict(
        pfa.flash_attention.bwd_launches)
    got.backward(pdo)
    assert (pfa.flash_attention.launches,
            pfa.flash_attention.bwd_launches) == before
    _close(got.detach(), out, 3e-5)
    for t, w in zip(leaves, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("bh,bh_kv,sq,skv,d,dv,causal", [
    (4, 4, 40, 40, 16, 16, True), (8, 1, 33, 33, 32, 32, True),
    (6, 3, 20, 45, 24, 16, False)])
def test_plain_backward_matches_autograd_through_the_plain_forward(
        bh, bh_kv, sq, skv, d, dv, causal):
    _, (q, k, v, do) = _inputs(bh * sq + d, (bh, sq, d), (bh_kv, skv, d),
                               (bh_kv, skv, dv), (bh, sq, dv))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = pref.attention_ref(*leaves, causal=causal)
    out.backward(do)
    got = pref.attention_bwd_ref(q, k, v, out.detach(), do, causal=causal)
    for g, t in zip(got, leaves):
        assert g.dtype == t.dtype and g.shape == t.shape
        torch.testing.assert_close(g, t.grad, rtol=1e-5, atol=1e-6)


def test_gradcheck_in_float64():
    gen = torch.Generator().manual_seed(5)
    for causal, shapes in ((True, ((4, 9, 8), (2, 9, 8), (2, 9, 8))),
                           (False, ((2, 5, 8), (1, 7, 8), (1, 7, 8)))):
        q, k, v = (torch.randn(*s, generator=gen, dtype=torch.float64,
                               requires_grad=True) for s in shapes)
        assert torch.autograd.gradcheck(
            lambda *a: pfa.flash_attention(*a, causal=causal), (q, k, v))


def test_a_backward_with_a_q_offset_is_refused():
    """An offset query block is a decode step: its backward raises, naming
    the reason."""
    _, (q, k, v) = _inputs(4, (2, 8, 16), (2, 40, 16), (2, 40, 16))
    q.requires_grad_(True)
    out = pfa.flash_attention(q, k, v, causal=True, q_offset=32)
    with pytest.raises(NotImplementedError, match="q_offset = 0 only"):
        out.sum().backward()


# (BH, BH_kv, Sq, Skv, D, Dv, causal): GQA causal and non-causal (a cross
# shape), group 1, MLA's narrower values at its smoke and full widths
STAT_SHAPES = [(8, 2, 40, 40, 16, 16, True), (6, 3, 33, 50, 24, 24, False),
               (4, 4, 70, 70, 32, 32, True), (4, 4, 40, 40, 48, 32, True),
               (2, 2, 64, 64, 192, 128, False)]


@pytest.mark.parametrize("bh,bh_kv,sq,skv,d,dv,causal", STAT_SHAPES)
def test_plain_lse_matches_jax_logsumexp(bh, bh_kv, sq, skv, d, dv, causal):
    """The log-normaliser the plain forward returns (what the forward
    kernel writes for the backward) against ``jax.nn.logsumexp`` of the
    masked, scaled scores computed in JAX: float32 at rtol 1e-6."""
    (q, k, v), (pq, pk, pv) = _inputs(bh * sq + d, (bh, sq, d),
                                      (bh_kv, skv, d), (bh_kv, skv, dv))
    out, lse = pref.attention_ref(pq, pk, pv, causal=causal,
                                  return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (bh, sq)
    torch.testing.assert_close(out, pref.attention_ref(pq, pk, pv,
                                                       causal=causal),
                               rtol=0, atol=0)
    s = jnp.einsum("bqd,bkd->bqk", q,
                   jnp.repeat(k, bh // bh_kv, axis=0)) * d ** -0.5
    if causal:
        s = jnp.where(jnp.arange(sq)[:, None] >= jnp.arange(skv)[None, :],
                      s, -jnp.inf)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jax.nn.logsumexp(s, axis=-1)),
                               rtol=1e-6)


@pytest.mark.parametrize("bh,bh_kv,sq,skv,d,dv,causal", STAT_SHAPES)
def test_delta_ref_matches_the_rowsum_in_jax(bh, bh_kv, sq, skv, d, dv,
                                             causal):
    """K0's plain version ``delta_ref`` against ``rowsum(do * o)`` of the
    reference's attention output, computed in JAX: float32 at rtol 1e-6
    (atol 1e-6 for rows that nearly cancel)."""
    (q, k, v, do), (_, _, _, pdo) = _inputs(
        bh * sq + dv, (bh, sq, d), (bh_kv, skv, d), (bh_kv, skv, dv),
        (bh, sq, dv))
    o = rref.attention_ref(q, k, v, causal=causal)
    got = pref.delta_ref(torch.from_numpy(np.array(o)), pdo)
    assert got.dtype == torch.float32 and got.shape == (bh, sq)
    np.testing.assert_allclose(got.numpy(), np.asarray(jnp.sum(do * o, -1)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("b,sq,skv,h,kh,d,dv,causal", [
    (2, 40, 40, 4, 2, 16, 16, True), (1, 70, 70, 8, 1, 32, 32, True),
    (2, 33, 50, 4, 2, 24, 24, False), (2, 40, 40, 4, 4, 48, 32, True)])
def test_plain_backward_on_the_forward_lse_matches_jax_grad(
        b, sq, skv, h, kh, d, dv, causal):
    """``attention_bwd_ref`` given the plain forward's lse (P = exp(s -
    lse), as the kernels form it) against ``jax.vjp`` of the reference's
    blockwise attention, in the kernels' (BH, S, D) layout: float32 at
    rtol 1e-5, atol 1e-6, on the inputs of
    ``test_gradients_match_jax_grad_of_the_reference``."""
    (q, k, v, do), arrs = _inputs(sq * skv + d, (b, sq, h, d),
                                  (b, skv, kh, d), (b, skv, kh, dv),
                                  (b, sq, h, dv))
    _, vjp = jax.vjp(lambda *a: RL.blockwise_attention(
        *a, causal=causal, block=32), q, k, v)
    want = vjp(do)

    def rows(t):       # (B, S, H, D) -> (B * H, S, D)
        return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])
    pq, pk, pv, pdo = map(rows, arrs)
    out, lse = pref.attention_ref(pq, pk, pv, causal=causal,
                                  return_lse=True)
    got = pref.attention_bwd_ref(pq, pk, pv, out, pdo, causal=causal,
                                 lse=lse)
    for g, w in zip(got, want):
        w = np.asarray(w)
        g = g.reshape(w.shape[0], w.shape[2], w.shape[1], w.shape[3])
        np.testing.assert_allclose(g.transpose(1, 2).numpy(), w,
                                   rtol=1e-5, atol=1e-6)


def test_flash_attention_saves_lse_only_for_a_gradient(monkeypatch):
    """``FlashAttention`` asks the forward for lse, and saves it beside q,
    k, v and the output, only when one of q, k and v needs a gradient
    (and the query block is not offset); otherwise the kernel writes none
    and nothing is saved."""
    asked = []
    real = pfa.flash_attention_fwd

    def spy(*a, **kw):
        asked.append(kw["want_lse"])
        return real(*a, **kw)
    monkeypatch.setattr(pfa, "flash_attention_fwd", spy)
    _, (q, k, v) = _inputs(9, (4, 24, 16), (2, 24, 16), (2, 24, 16))
    out = pfa.flash_attention(q, k, v)
    assert asked == [False] and out.grad_fn is None
    k.requires_grad_(True)
    out = pfa.flash_attention(q, k, v)
    assert asked[-1] is True
    *tensors, lse = out.grad_fn.saved_tensors
    assert [t is u for t, u in zip(tensors, (q, k, v))] == [True] * 3
    assert lse.dtype == torch.float32 and lse.shape == (4, 24)
    torch.testing.assert_close(
        lse, pref.attention_ref(q, k, v, return_lse=True)[1], rtol=0, atol=0)
    pfa.flash_attention(q[:, -8:].contiguous(), k, v, q_offset=16)
    assert asked[-1] is False

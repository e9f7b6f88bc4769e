"""The port's AdamW and gradient compression against the reference's:
five AdamW steps on a random tree of seeded numpy gradients at float32
moments (rtol 1e-5) and at int8 moments (values and scales equal, or at
most one int8 step apart, with the count of such elements stated), the
learning-rate schedule at every step, ``ef_compress_tree`` and
``decompress_tree``, the optimizer state's meta tree, and the counterparts
of the reference's own optimizer tests (``tests/test_runtime.py``)."""
import dataclasses

import hypothesis
import hypothesis.strategies as st
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro.optim import compress as rcompress
from repro_torch import tree as T
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.meta import ParamMeta, is_meta
from repro_torch.optim import adamw as padamw
from repro_torch.optim import compress as pcompress

# keys in sorted order, so that insertion order is jax's leaf order
SHAPES = {"embed": (32, 16), "experts": (3, 16, 8), "layers": [
    {"wo": (24, 16), "wq": (16, 24)}, {"wo": (24, 16), "wq": (16, 24)}],
    "norm": (16,)}


def _is_shape(x):
    return isinstance(x, tuple)


def _draw(rng, scale=1.0):
    return T.tree_map(
        lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
        SHAPES, is_leaf=_is_shape)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _torch(tree):
    return T.tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def _run_both(cfg_kw, steps=5):
    rng = np.random.default_rng(0)
    params = _draw(rng)
    grads = [_draw(rng, 0.3) for _ in range(steps)]
    rcfg = radamw.AdamWConfig(**cfg_kw)
    pcfg = padamw.AdamWConfig(**cfg_kw)
    rp, pp = _jax(params), _torch(params)
    rs, ps = radamw.init(rp, rcfg), padamw.init(pp, pcfg)
    metrics = []
    for g in grads:
        rp, rs, rm = radamw.update(_jax(g), rs, rp, rcfg)
        pp, ps, pm = padamw.update(_torch(g), ps, pp, pcfg)
        metrics.append((rm, pm))
    return rp, rs, pp, ps, metrics


def test_adamw_five_steps_match_the_reference_at_float32_moments():
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=8)
    rp, rs, pp, ps, metrics = _run_both(kw)
    for want, got in zip(jax.tree_util.tree_leaves(rp), T.leaves(pp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
    for name in ("m", "v"):
        for want, got in zip(jax.tree_util.tree_leaves(rs[name]),
                             T.leaves(ps[name])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-9)
    assert int(ps["step"]) == int(rs["step"]) == 5
    for rm, pm in metrics:
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]),
                                   rtol=1e-6)


def test_adamw_five_steps_match_the_reference_at_int8_moments():
    """Equal int8 moments, or one int8 step apart where the float32 moment
    before requantization sits on a rounding edge; 0 such elements in this
    case (asserted), and scales at rtol 1e-6."""
    kw = dict(lr=1e-2, warmup_steps=2, decay_steps=8,
              quantize_moments=True)
    rp, rs, pp, ps, _ = _run_both(kw)
    for want, got in zip(jax.tree_util.tree_leaves(rp), T.leaves(pp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7)
    apart = 0
    for name in ("m", "v"):
        rpairs = jax.tree_util.tree_leaves(
            rs[name], is_leaf=lambda x: isinstance(x, dict) and "q" in x)
        ppairs = T.leaves(ps[name], is_leaf=padamw.is_moment_pair)
        assert len(rpairs) == len(ppairs)
        for want, got in zip(rpairs, ppairs):
            dq = np.abs(got["q"].numpy().astype(np.int32)
                        - np.asarray(want["q"]).astype(np.int32))
            assert got["q"].dtype == torch.int8
            assert int(dq.max()) <= 1
            apart += int((dq == 1).sum())
            np.testing.assert_allclose(got["scale"].numpy(),
                                       np.asarray(want["scale"]), rtol=1e-6)
    assert apart == 0


def test_schedule_matches_the_reference_at_every_step():
    for kw in (dict(), dict(warmup_steps=5, decay_steps=12),
               dict(lr=1e-3, warmup_steps=0, decay_steps=3)):
        rcfg, pcfg = radamw.AdamWConfig(**kw), padamw.AdamWConfig(**kw)
        for step in range(0, 40):
            want = float(rcfg.schedule(jnp.asarray(step, jnp.int32)))
            got = float(pcfg.schedule(torch.tensor(step, dtype=torch.int32)))
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_state_meta_mirrors_the_reference():
    meta = T.tree_map(lambda s: ParamMeta(s, (None,) * len(s)), SHAPES,
                      is_leaf=_is_shape)
    for q in (False, True):
        sm = padamw.state_meta(meta, padamw.AdamWConfig(quantize_moments=q))
        state = padamw.init(_torch(_draw(np.random.default_rng(1))),
                            padamw.AdamWConfig(quantize_moments=q))
        metas = T.leaves(sm, is_leaf=is_meta)
        tensors = T.leaves(state)
        assert [m.shape for m in metas] == [tuple(t.shape) for t in tensors]
        assert [m.dtype for m in metas] == [t.dtype for t in tensors]


def test_ef_compress_and_decompress_trees_match_the_reference():
    rng = np.random.default_rng(3)
    grads = _draw(rng)
    err = _draw(rng, 0.01)
    (rq, re), (pq, pe) = (rcompress.ef_compress_tree(_jax(grads), _jax(err)),
                          pcompress.ef_compress_tree(_torch(grads),
                                                     _torch(err)))
    pairs = T.leaves(pq, is_leaf=lambda x: isinstance(x, tuple))
    rpairs = jax.tree_util.tree_leaves(
        rq, is_leaf=lambda x: isinstance(x, tuple))
    for (q, s), (wq, ws) in zip(pairs, rpairs):
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(ws))
    for got, want in zip(T.leaves(pe), jax.tree_util.tree_leaves(re)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(T.leaves(pcompress.decompress_tree(pq)),
                         jax.tree_util.tree_leaves(
                             rcompress.decompress_tree(rq))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    zeros = pcompress.init_error_buf(_torch(grads))
    assert all(not bool(z.any()) and z.dtype == torch.float32
               for z in T.leaves(zeros))


def test_the_compressed_psum_waits_for_the_mesh():
    """On a mesh of one device the compressed psum is the reference's
    quantise-dequantise round trip of each leaf (the sum over four ranks:
    ``tests/test_torch_mesh.py``)."""
    mesh = make_local_mesh(1, 1, device="cpu")
    g = np.random.default_rng(0).standard_normal((3, 8)).astype(np.float32)
    got = pcompress.crosspod_compressed_psum({"w": torch.from_numpy(g)},
                                             "data", mesh)
    want = rcompress.decompress(*rcompress.compress(jnp.asarray(g)))
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want))


# ------------------------------------------- the reference's own tests
def test_adamw_optimizes_quadratic():
    cfg = padamw.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                             decay_steps=200)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = padamw.init(params, cfg)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = padamw.update(grads, state, params, cfg)
    assert float(params["w"].abs().max()) < 0.15


def test_quantized_moments_track_exact():
    kw = dict(lr=0.05, weight_decay=0.0, warmup_steps=1, decay_steps=100)
    cfg_q = padamw.AdamWConfig(quantize_moments=True, **kw)
    cfg_f = padamw.AdamWConfig(quantize_moments=False, **kw)
    p_q = {"w": torch.linspace(-1, 1, 64).reshape(8, 8)}
    p_f = {"w": p_q["w"].clone()}
    s_q, s_f = padamw.init(p_q, cfg_q), padamw.init(p_f, cfg_f)
    gen = torch.Generator().manual_seed(0)
    for _ in range(30):
        g = {"w": torch.randn(8, 8, generator=gen)}
        p_q, s_q, _ = padamw.update(g, s_q, p_q, cfg_q)
        p_f, s_f, _ = padamw.update(g, s_f, p_f, cfg_f)
    err = float((p_q["w"] - p_f["w"]).abs().max())
    assert err < 0.08, err


@hypothesis.settings(deadline=None, max_examples=20)
@hypothesis.given(st.integers(0, 2 ** 31 - 1))
def test_grad_compression_error_feedback_bounded(seed):
    """EF invariant: the residual stays within two quantization steps."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((4, 128)).astype(np.float32))
    err = torch.zeros_like(g)
    for _ in range(5):
        (q, s), err = pcompress.ef_compress_tree(g, err)
    step = float(g.abs().max()) / 127.0
    assert float(err.abs().max()) <= 2.0 * step + 1e-6


def test_compress_roundtrip_small_error():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((16, 256)).astype(np.float32))
    q, s = pcompress.compress(x)
    err = (pcompress.decompress(q, s) - x).abs()
    assert float(err.max()) <= float(x.abs().max()) / 127.0 + 1e-6


def test_adamw_rounds_half_to_even_as_jnp_round():
    """The int8 quantizer's rounding: torch.round and jnp.round both send
    halves to the even neighbour."""
    x = np.asarray([[-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 127.0]], np.float32)
    q, _ = padamw._quantize(torch.from_numpy(x))
    rq, _ = radamw._quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))


def test_config_fields_mirror_the_reference():
    names = [f.name for f in dataclasses.fields(radamw.AdamWConfig)]
    assert [f.name for f in dataclasses.fields(padamw.AdamWConfig)] == names

"""Wrappers of the flash-attention kernels: the forward
(``csrc/flash_attention.cu``, ``repro_flash_attention``), which replaces
``flash_attention_pallas``, and its backward (``csrc/flash_attention_bwd.cu``:
K0 ``repro_flash_bwd_prep``, the delta pass, K1 ``repro_flash_bwd_dkdv`` and
K2 ``repro_flash_bwd_dq``), which the reference has no kernel for (it
differentiates the pure-jnp twin of its Pallas kernel).

:func:`flash_attention` goes through :class:`FlashAttention`, an
``autograd.Function``: when an input needs a gradient its forward has the
forward kernel write each row's log-normaliser lse beside the output and
saves q, k, v, the output and lse, and its backward launches K0-K2
through :func:`flash_attention_bwd`.  For CUDA tensors each wrapper
launches its kernels (and raises on anything they cannot take); only for
tensors on the CPU does it run the plain versions of ``ref.py``, in both
directions.
``flash_attention.launches`` counts the forward kernel's launches and
``flash_attention.bwd_launches`` those of K0-K2 by name.  While a plain
version runs, ``flash_attention.plain_scores`` holds the ``(Sq, Skv)``
shape of the scores it puts in memory, which ``launch.op_analysis`` counts
as score traffic (the bytes the kernels keep on chip); else it is None.

For fake tensors (a ``FakeTensorMode`` trace: the dry run) neither wrapper
launches anything or runs a plain version, which would materialise the
``(Sq, Skv)`` scores: each calls a shape-only op
(``torch.ops.repro_torch.flash_attention_fwd`` / ``_bwd``) whose outputs
have the kernels' shapes and dtypes, whose flop formula counts the
kernels' own products (:func:`attention_flops` forward, 2.5 times that
for the backward's five) and whose operands and results are the bytes
the kernels move (the backward's include K0's float32 ``delta``).  Unlike the
Pallas kernel, the lengths need not be multiples of a tile: the kernels
mask the ragged edge themselves, and v may be narrower than q and k (MLA's
128-wide values under 192-wide queries and keys).  The backward takes
``q_offset = 0`` only: an offset query block is a decode step, which
never trains.
"""
from __future__ import annotations

import contextlib

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build
from repro_torch.kernels.common import on_cpu, require_aligned, require_cuda
from repro_torch.kernels.flash_attention import ref

# the bf16 kernel's instances: (q/k width, v width), each padded to 64
BF16_WIDTHS = ((64, 64), (128, 128), (192, 128))


def _padded(x: int) -> int:
    return -(-x // 64) * 64


def kernel_takes(d: int, dv: int, dtype: torch.dtype) -> bool:
    """Whether the kernel has an instance for q/k width ``d`` and v width
    ``dv`` (multiples of 8, ``dv <= d``) in ``dtype``: bf16 by the widths
    padded to 64 (:data:`BF16_WIDTHS`); float32 ``dv == d <= 128``, or
    ``d <= 192`` with ``dv <= 128``."""
    if d % 8 or dv % 8 or not 0 < dv <= d:
        return False
    if dtype == torch.bfloat16:
        return (_padded(d), _padded(dv)) in BF16_WIDTHS
    return dv == d <= 128 or (d <= 192 and dv <= 128)


def _check_widths(q: torch.Tensor, d: int, dv: int) -> None:
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash_attention takes bfloat16 or float32, not "
                        f"{q.dtype}")
    if not kernel_takes(d, dv, q.dtype):
        raise ValueError(
            f"head dims q/k {d}, v {dv}: each must be a multiple of 8 with "
            f"v's at most q's, and the {q.dtype} kernel has no instance for "
            f"them (bf16 widths padded to 64: {BF16_WIDTHS}; float32: equal "
            "widths up to 128, or up to 192 with v's up to 128)")


def causal_pairs(sq: int, skv: int, q_offset: int = 0) -> int:
    """The (query, key) pairs causal attention visits: query ``i`` sees the
    keys ``j <= q_offset + i`` that exist."""
    a = q_offset + 1                   # keys query 0 sees
    full = min(max(skv - a + 1, 0), sq)  # queries that see fewer than skv
    return full * a + full * (full - 1) // 2 + (sq - full) * skv


def attention_flops(bh: int, sq: int, skv: int, d: int, dv: int,
                    causal: bool, q_offset: int = 0) -> int:
    """Operations of Q K^T (``d`` wide) and P V (``dv`` wide) over the
    (query, key) pairs the inputs need."""
    pairs = causal_pairs(sq, skv, q_offset) if causal else sq * skv
    return 2 * bh * pairs * (d + dv)


@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _shape_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool, q_offset: int, want_lse: bool
               ) -> tuple[torch.Tensor, torch.Tensor]:
    raise RuntimeError("repro_torch::flash_attention_fwd is shape-only: "
                       "it runs on fake tensors")


@_shape_fwd.register_fake
def _(q, k, v, causal, q_offset, want_lse):
    bh, sq, _ = q.shape
    return (q.new_empty((bh, sq, v.shape[-1])),
            q.new_empty((bh, sq if want_lse else 0), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, causal, q_offset, want_lse, *,
               out_shape=None, **kwargs) -> int:
    return attention_flops(q_shape[0], q_shape[1], k_shape[1], q_shape[2],
                           v_shape[2], causal, q_offset)


@torch.library.custom_op("repro_torch::flash_attention_bwd", mutates_args=())
def _shape_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
               causal: bool) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor, torch.Tensor]:
    raise RuntimeError("repro_torch::flash_attention_bwd is shape-only: "
                       "it runs on fake tensors")


@_shape_bwd.register_fake
def _(q, k, v, out, dout, lse, causal):
    return (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v),
            torch.empty_like(lse))


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
               **kwargs) -> int:
    causal = args[3]
    return 5 * attention_flops(q_shape[0], q_shape[1], k_shape[1],
                               q_shape[2], v_shape[2], causal) // 2


@contextlib.contextmanager
def _plain(sq: int, skv: int):
    flash_attention.plain_scores = (sq, skv)
    try:
        yield
    finally:
        flash_attention.plain_scores = None


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, sm_scale: float | None = None,
                        q_offset: int = 0, want_lse: bool = False
                        ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The forward kernel's launch (or, on the CPU, its plain version):
    ``(out, lse)``, lse the float32 ``(BH, Sq)`` log-normaliser of each
    row's scaled scores when ``want_lse`` (what K1 and K2 read), else
    None and the kernel writes none."""
    bh, sq, d = q.shape
    bh_kv, skv = k.shape[0], k.shape[1]
    dv = v.shape[-1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if isinstance(q, FakeTensor):
        out, lse = torch.ops.repro_torch.flash_attention_fwd(
            q, k, v, causal, q_offset, want_lse)
        return out, lse if want_lse else None
    if on_cpu(q, k, v):
        with _plain(sq, skv):
            out = ref.attention_ref(q, k, v, causal=causal,
                                    sm_scale=sm_scale, q_offset=q_offset,
                                    return_lse=want_lse)
        return out if want_lse else (out, None)
    _check_widths(q, d, dv)
    if sq == 0 or skv == 0:
        raise ValueError("flash_attention needs at least one query and key")
    dev = require_cuda({"q": q, "k": k, "v": v},
                       dict.fromkeys("qkv", q.dtype),
                       {"q": (bh, sq, d), "k": (bh_kv, skv, d),
                        "v": (bh_kv, skv, dv)})
    require_aligned(q=q, k=k, v=v)
    out = q.new_empty((bh, sq, dv))
    lse = (torch.empty((bh, sq), dtype=torch.float32, device=dev)
           if want_lse else None)
    rc = build.library("flash_attention").repro_flash_attention(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
        None if lse is None else build.ptr(lse), bh, bh_kv, sq, skv, d, dv,
        float(sm_scale), int(causal), int(q_offset),
        int(q.dtype == torch.bfloat16), build.stream(dev))
    build.check(rc, "flash_attention kernel")
    flash_attention.launches += 1
    return out, lse


BWD_KERNELS = ("flash_attention_bwd_prep", "flash_attention_bwd_dkdv",
               "flash_attention_bwd_dq")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor,
                        lse: torch.Tensor, *, causal: bool = True,
                        sm_scale: float | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients ``(dq, dk, dv)`` of attention over q ``(BH, Sq, D)``,
    k ``(BH_kv, Skv, D)`` and v ``(BH_kv, Skv, Dv)`` with ``q_offset = 0``,
    given the forward's ``out``, its float32 ``lse`` ``(BH, Sq)`` (from
    :func:`flash_attention_fwd` with ``want_lse``) and the output's
    gradient ``dout`` ``(BH, Sq, Dv)``: K0 (delta), K1 and K2 for CUDA
    tensors, ``ref.attention_bwd_ref`` for tensors on the CPU.  K0's
    float32 ``delta`` ``(BH, Sq)`` is scratch allocated here."""
    bh, sq, d = q.shape
    bh_kv, skv = k.shape[0], k.shape[1]
    dv = v.shape[-1]
    if sm_scale is None:
        sm_scale = d ** -0.5
    if isinstance(q, FakeTensor):
        dq, dk, dv_out, _ = torch.ops.repro_torch.flash_attention_bwd(
            q, k, v, out, dout, lse, causal)
        return dq, dk, dv_out
    if on_cpu(q, k, v, out, dout, lse):
        with _plain(sq, skv):
            return ref.attention_bwd_ref(q, k, v, out, dout, causal=causal,
                                         sm_scale=sm_scale, lse=lse)
    _check_widths(q, d, dv)
    dev = require_cuda(
        {"q": q, "k": k, "v": v, "out": out, "dout": dout, "lse": lse},
        {**dict.fromkeys(("q", "k", "v", "out", "dout"), q.dtype),
         "lse": torch.float32},
        {"q": (bh, sq, d), "k": (bh_kv, skv, d), "v": (bh_kv, skv, dv),
         "out": (bh, sq, dv), "dout": (bh, sq, dv), "lse": (bh, sq)})
    require_aligned(out=out, dout=dout)
    lib = build.library("flash_attention_bwd")
    delta = torch.empty_like(lse)
    dq, dk, dv_out = (torch.empty_like(t) for t in (q, k, v))
    is_bf16 = int(q.dtype == torch.bfloat16)
    stream = build.stream(dev)
    shape = (bh, bh_kv, sq, skv, d, dv, float(sm_scale), int(causal),
             is_bf16, stream)
    p = build.ptr
    launches = (
        (lib.repro_flash_bwd_prep, (p(out), p(dout), p(delta), bh, sq, dv,
                                    is_bf16, stream)),
        (lib.repro_flash_bwd_dkdv, (*map(p, (q, k, v, dout, lse, delta, dk,
                                             dv_out)), *shape)),
        (lib.repro_flash_bwd_dq, (*map(p, (q, k, v, dout, lse, delta, dq)),
                                  *shape)))
    for name, (fn, args) in zip(BWD_KERNELS, launches):
        build.check(fn(*args), f"{name} kernel")
        flash_attention.bwd_launches[name] += 1
    return dq, dk, dv_out


class FlashAttention(torch.autograd.Function):
    """Attention with the forward kernel forward and K0-K2 backward (the
    plain versions for CPU tensors).  When q, k or v needs a gradient (and
    ``q_offset`` is 0) the forward kernel also writes lse, and q, k, v,
    the output and lse are saved; else nothing is saved."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float,
                q_offset: int):
        # grad mode is off inside forward: ask autograd what it will need
        want_lse = any(ctx.needs_input_grad[:3]) and q_offset == 0
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       sm_scale=sm_scale, q_offset=q_offset,
                                       want_lse=want_lse)
        if want_lse:
            ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.q_offset = causal, sm_scale, q_offset
        return out

    @staticmethod
    def backward(ctx, dout):
        if ctx.q_offset:
            raise NotImplementedError(
                f"flash_attention's backward takes q_offset = 0 only, got "
                f"{ctx.q_offset}: an offset query block is a decode step, "
                "which the train path never differentiates")
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         lse, causal=ctx.causal,
                                         sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q ``(BH, Sq, D)``; k ``(BH_kv, Skv, D)``, v ``(BH_kv, Skv, Dv)`` with
    ``BH % BH_kv == 0`` and ``Dv <= D`` -> ``(BH, Sq, Dv)`` in q's type (see
    ``ref.attention_ref``), differentiable through :class:`FlashAttention`
    (``q_offset = 0``)."""
    bh, _, d = q.shape
    bh_kv = k.shape[0]
    if bh_kv == 0 or bh % bh_kv:
        raise ValueError(f"q rows {bh} are not a multiple of kv rows {bh_kv}")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    if sm_scale is None:
        sm_scale = d ** -0.5
    return FlashAttention.apply(q, k, v, causal, float(sm_scale),
                                int(q_offset))


flash_attention.launches = 0
flash_attention.bwd_launches = dict.fromkeys(BWD_KERNELS, 0)
flash_attention.plain_scores = None

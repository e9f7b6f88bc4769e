"""Gradient compression with error feedback.

A port of ``repro.optim.compress``: int8 per-row absmax quantization of
the gradients before a cross-replica reduction, with a persistent
error-feedback buffer so that the quantization error is re-injected the
next step.  ``crosspod_compressed_psum`` is the reduction over one mesh
axis.
"""
from __future__ import annotations

import torch

from repro_torch import tree as T

F32 = torch.float32


def compress(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 values, float32 row scales)."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-20)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(F32)


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(F32) * scale


def ef_compress_tree(grads, error_buf):
    """Quantize the gradients plus the accumulated error; returns (a tree
    of ``(q, scale)`` pairs, the new error buffer)."""
    pairs, errors = [], []
    for g, e in zip(T.leaves(grads), T.leaves(error_buf), strict=True):
        g = g.to(F32) + e
        q, s = compress(g)
        pairs.append((q, s))
        errors.append(g - decompress(q, s))
    return T.unflatten_like(grads, pairs), T.unflatten_like(grads, errors)


def _is_pair(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2


def decompress_tree(q_tree):
    return T.tree_map(lambda qs: decompress(*qs), q_tree, is_leaf=_is_pair)


def init_error_buf(params):
    return T.tree_map(
        lambda p: torch.zeros(p.shape, dtype=F32, device=p.device), params)


def crosspod_compressed_psum(grads, axis_name: str, mesh):
    """The compressed all-reduce over the mesh axis ``axis_name``: each
    leaf (this rank's local tensor; a DTensor's ``to_local()``) is
    quantised and dequantised (:func:`compress`, :func:`decompress`) and
    the float32 values are summed over that axis's ranks.  The reference
    calls it inside ``shard_map``, whose ambient mesh names the axis;
    here ``mesh`` (a ``DeviceMesh``) stands in for it, and every rank of
    the axis makes the call.  The payload summed is the dequantised
    float32, as in the reference: the int8 wire format is not modelled.
    Returns plain float32 tensors in the tree's structure."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    group = mesh.get_group(axis_name)

    def one(g):
        if isinstance(g, DTensor):
            g = g.to_local()
        out = decompress(*compress(g.to(F32)))
        dist.all_reduce(out, group=group)
        return out
    return T.tree_map(one, grads)

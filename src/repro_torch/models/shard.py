"""The LM's sharding points: where a step whose parameters are DTensors
(the dry run's fake meshes) redistributes or runs on each device's local
shards.  Every function here is the identity, or the plain code, for plain
tensors, so the one-card path does not change.

* :func:`constrain` — ``boundary_sp``, the reference's
  ``with_sharding_constraint`` calls (``repro/models/lm.py:216-227``), and
  the train step's gradient reductions, as a ``redistribute``.
* :func:`embed` — the embedding lookup, vocab-sharded.
* :func:`residual` — a sub-layer's output is placed as the residual
  stream before it is added (the row-parallel projection's partial sums
  all-reduce), where DTensor would otherwise pick a layout per add.
* :func:`split_heads` / :func:`merge_heads` — the fused ``heads * d_head``
  projection is sharded over the ``model`` axis; where its shards split a
  head (2 kv heads, or 28 q heads, on 16 devices) the projection is first
  gathered over that axis (the collective GSPMD inserts there silently),
  and q is then re-sharded by whole heads (fewer heads than devices, as
  whisper's 12 on 16, stay whole on every device);
  :func:`rows_as` reduces a projection's partial sums onto the rows.
* :func:`local_attention` — attention on each device's (batch shard, head
  shard), on the DTensors' local tensors, so the flash op sees what one
  card would; each q head reads its own kv head.
* :func:`broadcast_heads` — MLA's one RoPE key expanded to each
  device's own heads; :func:`gathered` — its latent projections whole
  on every device; :func:`onto_heads` — its decode's latent output
  reduced onto the heads.
* :func:`expert_parallel` — the MoE's ``shard_map``: each device routes
  its own tokens to its own experts, and one all-reduce over the
  ``model`` axis sums the partial outputs.
* :func:`write_slot` — a decode step's cache write into the device's own
  sequence shard.
* :func:`logz_and_gold` — the loss's logsumexp and gold logit over
  vocab-sharded logits.
* :func:`softmax` — over a sharded axis as a partitioned softmax runs it:
  the max and the sum are all-reduced, the scores are never gathered.
* :func:`all_reduced`, :func:`as_partial` — partial sums reduced where
  the code says, not where DTensor's version would choose (the loss's
  row values; the global norm's terms, added up unreduced and reduced
  once).
* :func:`pin` — the identity, whose gradient keeps the forward's layout
  where DTensor's own choice would fail (an uneven head split, a
  flattened sequence shard).

Every device must issue the same collectives in the same order, so a
device's local gradients are made contiguous (DTensor chooses by
stride) and a device past the last head of an uneven split still
attends, over no query.  ``tests/torch_gloo_step.py`` holds the sharded
step against the one-process step with real values.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch import tree as T


def constrain(x, placements):
    """``x`` redistributed to ``placements`` (None: as it is)."""
    if placements is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, placements)


def pin(x):
    """``x`` as it is, with its gradient placed as ``x`` is: the backward
    keeps the forward's layout here instead of a layout DTensor picks
    (which can shard a sequence a flattened matmul cannot take)."""
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def embed(table, tokens):
    """``table[tokens]``; for DTensors the vocab-sharded lookup (each
    device looks up its rows, the partial rows all-reduce), placed as the
    tokens are.  A table whole over the vocab (a ``model`` axis of one
    device) is looked up on each device's own tokens, with no collective:
    its gradient, each device's rows added into the table, is partial
    over the axes that split the tokens and is reduced once with the
    other gradients."""
    if not isinstance(table, DTensor):
        return table[tokens]
    if not _dims_on(table, 0):
        local = _local(gathered(table), tuple(
            Partial() if isinstance(p, Shard) else Replicate()
            for p in tokens.placements))
        return _from_local(local[tokens.to_local()], tokens,
                           (*tokens.shape, table.shape[1]),
                           tokens.placements)
    x = F.embedding(tokens, table)
    return pin(x.redistribute(x.device_mesh, tokens.placements))


def residual(x, a):
    """``x + a``; a DTensor ``a`` (a projection's partial sums, say) is
    placed as the residual stream ``x`` first, which keeps the stream in
    one layout through the layers."""
    if isinstance(a, DTensor) and isinstance(x, DTensor):
        return pin(x + a.redistribute(x.device_mesh, x.placements))
    return x + a


def _dims_on(x: DTensor, dim: int) -> list[int]:
    """The mesh dimensions that shard tensor dimension ``dim`` (an axis of
    one device shards nothing)."""
    dim %= x.dim()
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim
            and x.device_mesh.size(i) > 1]


def _size(x: DTensor, mesh_dims: list[int]) -> int:
    n = 1
    for i in mesh_dims:
        n *= x.device_mesh.size(i)
    return n


def _with(x: DTensor, mesh_dims: list[int], placement) -> tuple:
    return tuple(placement if i in mesh_dims else p
                 for i, p in enumerate(x.placements))


def split_heads(t, n: int, dh: int):
    """``(b, s, n * dh) -> (b, s, n, dh)``.  A DTensor whose last axis is
    sharded over ``k`` devices with ``n % k != 0`` is gathered over them
    first, then, when ``n >= k``, sharded again by whole heads (unevenly:
    the devices hold ``ceil(n / k)`` heads or fewer)."""
    b, s = t.shape[0], t.shape[1]
    if not isinstance(t, DTensor):
        return t.reshape(b, s, n, dh)
    dims = _dims_on(t, -1)
    k = _size(t, dims)
    if n % k == 0:
        return t.reshape(b, s, n, dh)
    t = t.redistribute(t.device_mesh, _with(t, dims, Replicate()))
    t = t.reshape(b, s, n, dh)
    if n >= k:
        # the gradient comes back by whole heads too: DTensor cannot move
        # an uneven shard to another dimension
        t = pin(t.redistribute(t.device_mesh, _with(t, dims, Shard(2))))
    return t


def merge_heads(o):
    """``(b, s, n, dv) -> (b, s, n * dv)``, gathering a DTensor first where
    its heads are split unevenly over their devices; where they are whole
    on every device (fewer heads than devices) the gradient comes back
    whole too."""
    b, s, n, dv = o.shape
    if isinstance(o, DTensor):
        dims = _dims_on(o, 2)
        if not dims:
            return pin(o.reshape(b, s, n * dv))
        if n % _size(o, dims):
            o = o.redistribute(o.device_mesh, _with(o, dims, Replicate()))
            # the gradient comes back whole too, or it could not unflatten
            return pin(o.reshape(b, s, n * dv))
    return o.reshape(b, s, n * dv)


def gathered(w):
    """A DTensor (an FSDP-sharded weight) whole on every device, as the
    FSDP contract gathers a layer's weights before their product: left to
    DTensor, a product with it may shard its columns over ``model`` and
    leave the next product's sums partial."""
    if not isinstance(w, DTensor) or all(
            isinstance(p, Replicate) for p in w.placements):
        return w
    return w.redistribute(w.device_mesh, (Replicate(),) * w.device_mesh.ndim)


def onto_heads(x, like, dim: int):
    """``x`` (partial sums over a sequence shard, say) with its axis
    ``dim`` placed as ``like``'s heads (axis 2) are: a reduce-scatter onto
    the devices that hold them; its other partial sums reduced."""
    if not isinstance(x, DTensor):
        return x
    heads = _dims_on(like, 2)
    return x.redistribute(x.device_mesh, tuple(
        Shard(dim) if i in heads else Replicate() if isinstance(p, Partial)
        else p for i, p in enumerate(x.placements)))


def replicate_heads(x, dim: int = 2):
    """A DTensor's heads axis ``dim`` gathered onto every device, copied to
    a contiguous local tensor: an uneven gather can leave one device's
    copy strided, and ``contiguous`` looks only at the DTensor's global
    strides."""
    if not isinstance(x, DTensor):
        return x
    y = x.redistribute(x.device_mesh, _with(x, _dims_on(x, dim),
                                            Replicate()))
    # the local copy made by hand: DTensor's own clone of a tensor partial
    # over one axis may pick other placements (and shard the heads again)
    return _from_local(y.to_local().contiguous(), y, y.shape, y.placements)


def rows_as(t, x):
    """``t``, a projection of ``x``, with any partial sums reduced into
    ``x``'s placement on their axis (a reduce-scatter onto ``x``'s batch
    shards): against an FSDP weight DTensor may split a small product's
    contraction over the data axis and leave its sums partial, where
    attention on each device's rows needs them whole."""
    if not isinstance(t, DTensor) or not any(
            isinstance(p, Partial) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, tuple(
        x.placements[i] if isinstance(p, Partial) else p
        for i, p in enumerate(t.placements)))


def local_box(shape, mesh, placements) -> tuple[list[int], list[int]]:
    """(shape, offset) of this device's shard of a tensor of ``shape``
    under ``placements``: each ``Shard(d)`` in mesh order cuts the
    dimension into chunks of ``ceil(n / k)``, as ``torch.chunk`` does."""
    shape, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n, k = shape[p.dim], mesh.size(i)
            c = -(-n // k)
            lo = min(coord[i] * c, n)
            offset[p.dim] += lo
            shape[p.dim] = min(lo + c, n) - lo
    return shape, offset


def _local_range(x: DTensor, dim: int) -> tuple[int, int]:
    """(offset, length) of this device's shard along ``dim``."""
    shape, offset = local_box(x.shape, x.device_mesh, x.placements)
    return offset[dim], shape[dim]


def _from_local(local, like: DTensor, shape, placements) -> DTensor:
    """The DTensor of global ``shape`` whose shard here is ``local``, on
    ``like``'s mesh (``local_map`` would infer the global shape from the
    shard, which an uneven split gets wrong)."""
    return DTensor.from_local(local, like.device_mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _local(t, grad=None):
    """``t``'s shard here (its gradient placed by ``grad``, as ``t`` is by
    default).  Every device hands DTensor a gradient of one layout:
    DTensor picks its redistributions by stride, and a device's slice of
    a shard would otherwise differ from another's."""
    t = t.to_local(grad_placements=grad)
    if t.requires_grad:
        t.register_hook(lambda g: g.contiguous())
    return t


def broadcast_heads(t, like):
    """``t`` ``(B, S, 1, D)`` (MLA's one RoPE key) expanded to the heads
    of ``like`` ``(B, S, H, ...)``; for DTensors to the heads ``like``
    holds on each device, with no collective (its gradient, the sum over
    those heads, is partial over the devices that split them)."""
    b, s, h = like.shape[:3]
    if not isinstance(like, DTensor):
        return t.expand(b, s, h, t.shape[-1])
    heads = _dims_on(like, 2)
    rep = _with(like, heads, Replicate())
    t = t.redistribute(t.device_mesh, rep)
    local = _local(t, tuple(Partial() if i in heads else p
                            for i, p in enumerate(rep)))
    _, hl = _local_range(like, 2)
    return _from_local(local.expand(*local.shape[:2], hl, local.shape[3]),
                       like, (b, s, h, t.shape[-1]), like.placements)


def local_attention(attend, q, k, v, **kw):
    """``attend(q, k, v, **kw)`` (``(B, S, H, D)`` layout, GQA); for
    DTensors on each device's shards: q's batch and heads as they are
    sharded, k and v with the kv heads of those q heads (a slice when
    they group evenly, else one kv head per q head)."""
    if not isinstance(q, DTensor):
        return attend(q, k, v, **kw)
    h, kv = q.shape[2], k.shape[2]
    g = h // kv
    lo, hl = _local_range(q, 2)
    klo, _ = _local_range(k, 2)
    # a device past the last head of an uneven split attends no query over
    # one kv head, so its backward runs every collective the others run
    idx = [(lo + i) // g - klo for i in range(hl)] or [0]
    n_kv = len(set(idx))
    even = hl % n_kv == 0 and all(idx[i] == idx[0] + i // (hl // n_kv)
                                  for i in range(hl))

    def body(q_l, k_l, v_l):
        if even:
            k_l = k_l[:, :, idx[0]:idx[0] + n_kv]
            v_l = v_l[:, :, idx[0]:idx[0] + n_kv]
        else:
            pick = torch.tensor(idx, device=k_l.device)
            k_l = k_l.index_select(2, pick)
            v_l = v_l.index_select(2, pick)
        return attend(q_l, k_l, v_l, **kw)

    # k and v replicated where q's heads are sharded: each device's
    # gradient is a partial sum over the q heads it holds
    heads = _dims_on(q, 2)

    def partial(t):
        return _local(t, tuple(
            Partial() if i in heads and not (isinstance(p, Shard)
                                             and p.dim == 2) else p
            for i, p in enumerate(t.placements)))

    # contiguous, as the plain path's reshape makes it (a DTensor view
    # cannot copy)
    o = body(_local(q), partial(k), partial(v)).contiguous()
    return _from_local(o, q, (*q.shape[:3], v.shape[3]), q.placements)


def expert_parallel(body, params, x, dims, *, dp_axes=None):
    """``body(params, x, rank)`` run as a ``shard_map`` runs it: on each
    device's token shard and expert shard, its partial outputs summed over
    ``model`` by one all-reduce.  ``dims`` has ``params``' structure and
    names each leaf's dimension sharded over ``model`` (None: the leaf
    is whole on every device); ``rank`` is the device's index along
    ``model``.  ``x`` is placed with its batch over ``dp_axes`` (None:
    replicated) and whole over every other axis (a sequence sharded by
    boundary-SP is gathered first); every leaf is whole but for its
    ``dims`` shard (under FSDP its data shards are gathered, once a
    layer).  For plain tensors ``body(params, x, 0)``."""
    if not isinstance(x, DTensor):
        return body(params, x, 0)
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    ep = names.index("model")
    dp = {names.index(a) for a in ((dp_axes,) if isinstance(dp_axes, str)
                                   else dp_axes or ())}
    x_pl = tuple(Shard(0) if i in dp else Replicate()
                 for i in range(mesh.ndim))

    def grad_of(pl):
        # partial over the ep axis where the leaf is whole there (each
        # device's outputs are a part of the sum), and over the batch's
        # axes (each device's tokens are a part of the batch)
        return tuple(Partial() if i in dp or (i == ep and not isinstance(
            p, Shard)) else p for i, p in enumerate(pl))

    def leaf(w, dim):
        if dim is not None and w.shape[dim] % mesh.size(ep):
            raise ValueError(f"{w.shape[dim]} rows of dimension {dim} do "
                             f"not split over the {mesh.size(ep)}-way "
                             "model axis")
        pl = tuple(Shard(dim) if i == ep and dim is not None
                   else Replicate() for i in range(mesh.ndim))
        return _local(w.redistribute(mesh, pl), grad_of(pl))

    local_params = T.tree_map(leaf, params, dims)
    x_l = _local(x.redistribute(mesh, x_pl), tuple(
        Partial() if i == ep else p for i, p in enumerate(x_pl)))
    y = body(local_params, x_l, mesh.get_coordinate()[ep])
    y = _from_local(y, x, x.shape, tuple(Partial() if i == ep else p
                                         for i, p in enumerate(x_pl)))
    return y.redistribute(mesh, x_pl)


def write_slot(buf, pos: int, val) -> None:
    """``buf[:, pos] = val`` for a ``(B, S, ...)`` cache; a DTensor cache
    writes into the shard that holds ``pos``, on the device that holds
    it."""
    if not isinstance(buf, DTensor):
        buf[:, pos] = val
        return
    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1
                 else Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                 else p for p in buf.placements)
    local = val.redistribute(buf.device_mesh, want).to_local()
    off, n = _local_range(buf, 1)
    if off <= pos < off + n:
        buf.to_local()[:, pos - off] = local


def softmax(scores, dim: int = -1):
    """``torch.softmax``; over a sharded axis of a DTensor, the max and the
    sum reduce across the shards (all-reduces of one value a row)."""
    if not isinstance(scores, DTensor) or not _dims_on(scores, dim):
        return torch.softmax(scores, dim=dim)
    e = torch.exp(scores - scores.amax(dim=dim, keepdim=True))
    return e / e.sum(dim=dim, keepdim=True)


def all_reduced(x):
    """A DTensor's partial sums (or maxima) all-reduced, where DTensor's
    own choice (a reduce-scatter now and a gather later, or a reduction
    of each term of a sum, by torch's version) would depend on the ops
    that read them."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Partial) else p for p in x.placements))


def as_partial(x):
    """A DTensor made partial sums over every mesh axis it is replicated
    on, with no collective (the device at coordinate 0 of those axes
    keeps its value, the others hold zeros): terms so placed add up with
    no collective, for one :func:`all_reduced` of their sum.  Not
    differentiable."""
    if not isinstance(x, DTensor):
        return x
    rep = [i for i, p in enumerate(x.placements) if isinstance(p, Replicate)]
    coord = x.device_mesh.get_coordinate()
    local = x.to_local()
    if any(coord[i] for i in rep):
        local = torch.zeros_like(local)
    return DTensor.from_local(
        local, x.device_mesh, tuple(Partial() if i in rep else p
                                    for i, p in enumerate(x.placements)),
        run_check=False, shape=x.shape, stride=x.stride())


class _LogZ(torch.autograd.Function):
    """logsumexp over the last axis whose gradient, the softmax, is formed
    in the logits' own (vocab-sharded) layout."""

    @staticmethod
    def forward(ctx, logits):
        m = all_reduced(logits.amax(dim=-1, keepdim=True))
        logz = torch.log(all_reduced(torch.exp(logits - m).sum(
            dim=-1, keepdim=True))) + m
        ctx.save_for_backward(logits, logz)
        return logz[..., 0]

    @staticmethod
    def backward(ctx, g):
        logits, logz = ctx.saved_tensors
        return g[..., None] * torch.exp(logits - logz)


def logz_and_gold(logits, labels):
    """Each row's logsumexp and its label's logit.  Over DTensor logits
    sharded by vocab, as vocab-parallel cross-entropy computes them: the
    row max, the sum of exponentials and the gold logit (found on the one
    device whose vocab shard holds it) all-reduce, and the logits are
    never gathered."""
    if not isinstance(logits, DTensor) or not _dims_on(logits, -1):
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
        return logz, gold
    logits = pin(logits)
    logz = _LogZ.apply(logits)
    lo, n = _local_range(logits, logits.dim() - 1)

    def pick(l, y):
        idx = y - lo
        g = torch.take_along_dim(l, idx.clamp(0, n - 1)[..., None],
                                 dim=-1)[..., 0]
        return torch.where((idx >= 0) & (idx < n), g, 0.0)

    vocab = logits.dim() - 1
    out = tuple(Partial() if isinstance(p, Shard) and p.dim == vocab else p
                for p in logits.placements)
    gold = pick(logits.to_local(), labels.redistribute(
        labels.device_mesh, _with(logits, _dims_on(logits, -1),
                                  Replicate())).to_local())
    return logz, all_reduced(_from_local(gold, logits, logits.shape[:-1],
                                         out))

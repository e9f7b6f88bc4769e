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
* :func:`gathered` — MLA's latent projections whole on every device;
  :func:`onto_heads` — its decode's latent output reduced onto the
  heads.
* :func:`model_parallel` — a ``shard_map``: a body runs on each device's
  tokens and its shard of the ``model`` axis (the MoE's experts, MLA's
  and Mamba2's heads), issuing its own collectives (:class:`Local`), and
  one all-reduce over ``model`` sums the partial outputs; every
  gradient's placement is set by hand, none is left to DTensor.
  :func:`whole` places a body's result that every device holds alike,
  :func:`local_of` hands it a cache's shard to write.
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
import torch.distributed._functional_collectives as funcol
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


# torch 2.13 names them ``*_single``; earlier ones ``*_tensor``
_GATHER = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
_SCATTER = getattr(funcol, "reduce_scatter_single",
                   funcol.reduce_scatter_tensor)


class _AllReduce(torch.autograd.Function):
    """A local tensor summed over one mesh dimension; its gradient summed
    too (``partial``: each device's gradient is its part of the whole) or
    passed through (every device reads the same sum, and its gradient is
    whole on each)."""

    @staticmethod
    def forward(ctx, t, group, partial: bool):
        ctx.group, ctx.partial = group, partial
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            g = funcol.wait_tensor(funcol.all_reduce(g.contiguous(), "sum",
                                                     ctx.group))
        return g, None, None


class _AllGather(torch.autograd.Function):
    """Each device's equal share of dimension ``dim`` gathered whole over
    one mesh dimension; its gradient, each device's part of the whole,
    reduce-scattered back onto the shares."""

    @staticmethod
    def forward(ctx, t, group, dim: int):
        ctx.group, ctx.dim = group, dim
        return funcol.wait_tensor(_GATHER(t.contiguous(), dim, group))

    @staticmethod
    def backward(ctx, g):
        return funcol.wait_tensor(_SCATTER(g.contiguous(), "sum", ctx.dim,
                                           ctx.group)), None, None


class Local:
    """What a body run on each device's shards (:func:`model_parallel`)
    knows of the mesh: its ``rank`` along the ``model`` axis of ``size``
    devices, its share of a dimension split over that axis, and the
    collectives it issues itself, so that no DTensor chooses them: a sum
    over ``model`` (:meth:`psum`), a gather over it (:meth:`gather`) and a
    sum over the batch's axes (:meth:`batch_sum`).  ``Local()`` is one
    device, where each is the identity."""

    def __init__(self, mesh=None, ep: int = 0, dp=()):
        self.mesh, self.ep, self.dp = mesh, ep, tuple(dp)
        self.size = 1 if mesh is None else mesh.size(ep)
        self.rank = 0 if mesh is None else mesh.get_coordinate()[ep]

    def share(self, n: int) -> tuple[int, int]:
        """``[lo, hi)``: this device's equal share of ``n`` along
        ``model``."""
        if n % self.size:
            raise ValueError(f"{n} does not split over the {self.size}-way "
                             "model axis")
        c = n // self.size
        return self.rank * c, (self.rank + 1) * c

    def psum(self, t):
        """``t`` summed over ``model``, each device's gradient a part."""
        if self.size == 1:
            return t
        return _AllReduce.apply(t, (self.mesh, self.ep), True)

    def batch_sum(self, t):
        """``t`` summed over the batch's shards; every device reads the
        sum alike, so its gradient passes through."""
        for i in self.dp:
            t = _AllReduce.apply(t, (self.mesh, i), False)
        return t

    def gather(self, t, dim: int):
        """This device's share of ``t``'s dimension ``dim`` gathered whole
        over ``model``."""
        if self.size == 1:
            return t
        return _AllGather.apply(t, (self.mesh, self.ep), dim % t.dim())


def model_parallel(body, params, x, dims, *, dp_axes="x", out_dims=None):
    """``body(params, x, local)`` run as a ``shard_map`` runs it: on each
    device's token shard and its shard of the ``model`` axis, the partial
    outputs summed over ``model`` by one all-reduce.  ``dims`` has
    ``params``' structure and names each leaf's dimension split over
    ``model`` (None: whole on every device; under FSDP its data shards
    are gathered, once a layer); ``local`` is the body's :class:`Local`.
    ``x`` is placed with its batch over ``dp_axes`` (``"x"``: the axes
    that shard ``x``'s batch; None: replicated) and whole over every
    other axis.  Every gradient comes back placed by hand: a leaf's and
    ``x``'s partial over the batch's axes and over ``model`` where they
    are whole there.  With ``out_dims`` the body returns ``(y, extras)``,
    a tree of local tensors (a decode cache) whose batch is ``x``'s and
    whose dimension named in ``out_dims`` (None: none) is split over
    ``model``; they come back as DTensors so placed.  For plain tensors
    ``body(params, x, Local())``."""
    if not isinstance(x, DTensor):
        return body(params, x, Local())
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    ep = names.index("model")
    if dp_axes == "x":
        dp = {i for i, p in enumerate(x.placements)
              if isinstance(p, Shard) and p.dim == 0}
    else:
        dp = {names.index(a) for a in ((dp_axes,) if isinstance(dp_axes, str)
                                       else dp_axes or ())}
    dp -= {ep}
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
    out = body(local_params, x_l, Local(
        mesh, ep, sorted(i for i in dp if mesh.size(i) > 1)))
    y, extras = out if out_dims is not None else (out, None)
    y = _from_local(y, x, x.shape, tuple(Partial() if i == ep else p
                                         for i, p in enumerate(x_pl)))
    y = y.redistribute(mesh, x_pl)
    if out_dims is None:
        return y

    def place(t, dim):
        shape = [x.shape[0], *t.shape[1:]]
        if dim is not None:
            shape[dim] *= mesh.size(ep)
        return _from_local(t, x, shape, tuple(
            Shard(dim) if i == ep and dim is not None else p
            for i, p in enumerate(x_pl)))
    return y, T.tree_map(place, extras, out_dims)


def whole(t, like):
    """``t``, the same on every device, as a DTensor replicated on
    ``like``'s mesh (``like`` plain: ``t`` as it is)."""
    if not isinstance(like, DTensor):
        return t
    return _from_local(t, like, t.shape,
                       (Replicate(),) * like.device_mesh.ndim)


def local_of(t):
    """A DTensor's shard on this device (a plain tensor as it is): the
    tensor a body of :func:`model_parallel` writes a cache into."""
    return t.to_local() if isinstance(t, DTensor) else t


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

"""Per-device counts of a step traced on fake tensors: FLOPs, memory
traffic, collective bytes and the peak of live memory.

The port's counterpart of ``repro.launch.hlo_analysis``.  The reference
parses the optimised, SPMD-partitioned HLO text of a compiled program and
weights each computation by its loops' trip counts; torch has no such
program.  Here the step runs once, eagerly, on fake tensors (no
allocation, no arithmetic) under :class:`OpAnalysis`, a
``TorchDispatchMode`` that sees every aten op one device runs:

* DTensor ops are passed on (``NotImplemented``) and counted as the local
  ops and ``_c10d_functional`` collectives that DTensor issues for them,
  so every number is per device.  DTensor's own sharding propagation runs
  each op once more on global-shaped fake tensors; those runs are not the
  device's work and are not counted.
* FLOPs: ``torch.utils.flop_counter``'s formula for each op
  (``FlopCounterMode``'s registry: the matmuls, and the flash kernels'
  shape-only ops, whose formulas count the kernels' own products).
* Traffic: the bytes each op reads and writes, after the reference's
  per-instruction rules (``hlo_analysis._traffic_bytes``): a gather
  counts its window twice, an indexed update its update twice, and
  every other op (a matmul and a kernel too) its operands in full and
  its results.  Views, allocations and plain copies (same dtype)
  move nothing and count nothing.
* Score traffic: the bytes of the score-shaped operands and results of
  the ops a plain attention runs (``flash_attention.plain_scores``: the
  CPU's plain versions put the ``(Sq, Skv)`` scores in memory, as the
  reference's jnp attention puts its ``(block, block)`` tiles), which the
  flash kernels keep on chip.  On fake tensors the flash wrappers run
  their shape-only ops and no plain version, so in a dry run it is 0.
* Collectives: the per-device result bytes of each ``_c10d_functional``
  collective, by kind.
* Peak: the largest sum of the bytes of live storages (each tracked by a
  weak reference from the op that made it, or given as an argument).

The reference's ``missing_trip_counts`` has no meaning here: a trip count
is never missing from an eager trace.  One loop is weighted as the
reference weights a loop body: the train step's microbatches run the same
shapes, so the dry run runs the first under :meth:`OpAnalysis.repeat`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.flash_attention.flash_attention import \
    flash_attention

aten = torch.ops.aten

COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
# ops that move no bytes: allocations, metadata and the collectives' wait
FREE = {aten.empty.memory_format, aten.empty_strided.default,
        aten.new_empty.default, aten.new_empty_strided.default,
        aten.empty_like.default, aten.detach.default, aten.alias.default,
        aten.lift_fresh.default, aten._unsafe_view.default,
        torch.ops.prim.device.default}
GATHERS = {aten.index.Tensor, aten.embedding.default,
           aten.index_select.default, aten.gather.default}
# indexed updates: (the update's argument position)
UPDATES = {aten.index_put.default: 2, aten.index_put_.default: 2,
           aten._index_put_impl_.default: 2, aten.scatter.src: 3,
           aten.scatter_add.default: 3, aten.slice_scatter.default: 1,
           aten.select_scatter.default: 1, aten.index_add.default: 3}
COPIES = {aten.clone.default, aten.copy_.default, aten._to_copy.default,
          aten.copy.default}


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


@dataclasses.dataclass
class OpReport:
    flops: float
    traffic_bytes: float
    collective_bytes: dict[str, float]
    n_collectives: dict[str, int]
    score_traffic_bytes: float
    argument_bytes: int
    peak_bytes: int

    @property
    def total_collective_bytes(self) -> float:
        return float(sum(self.collective_bytes.values()))

    @property
    def kernel_adjusted_traffic(self) -> float:
        return max(self.traffic_bytes - self.score_traffic_bytes, 0.0)


class OpAnalysis(TorchDispatchMode):
    """Count the ops run under it (enter it inside the ``FakeTensorMode``
    of the trace).  :meth:`track`, called before it is entered, registers
    the step's arguments as live; :meth:`report` gives the counts."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.traffic = 0.0
        self.score_traffic = 0.0
        self.coll_bytes: dict[str, float] = defaultdict(float)
        self.n_coll: dict[str, int] = defaultdict(int)
        self.argument_bytes = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, weakref.finalize] = {}
        self._paused = 0
        self._prop = None
        self._weight = 1

    # ------------------------------------------------------------- memory
    def _hold(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until it dies; its bytes if it was
        not counted yet, else 0."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages and self._storages[key].alive:
            return 0
        n = st.nbytes()
        self._storages[key] = weakref.finalize(st, self._free, key, n)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def _free(self, key: int, n: int) -> None:
        self.live -= n
        self._storages.pop(key, None)

    def track(self, tree) -> int:
        """Count the tensors of ``tree`` (plain or DTensor: their local
        shards) as live arguments; returns their bytes."""
        n = 0
        for t in _tensors(tree):
            n += self._hold(t.to_local() if isinstance(t, DTensor) else t)
        self.argument_bytes += n
        return n

    @contextlib.contextmanager
    def repeat(self, n: int):
        """Count the ops run inside ``n`` times (one loop iteration that
        stands for ``n`` of the same shapes, as the reference weights a
        loop body by its trip count); the peak is not scaled."""
        self._weight *= n
        try:
            yield
        finally:
            self._weight //= n

    # ------------------------------------------------------ the dispatch
    def __enter__(self):
        # DTensor derives each op's global output shape by running it on
        # global-shaped fake tensors; pause the counts there
        prop = DTensor._op_dispatcher.sharding_propagator
        real = type(prop)._propagate_tensor_meta_non_cached

        def paused(op_schema):
            self._paused += 1
            try:
                return real(prop, op_schema)
            finally:
                self._paused -= 1

        prop._propagate_tensor_meta_non_cached = paused
        self._prop = prop
        return super().__enter__()

    def __exit__(self, *exc):
        del self._prop._propagate_tensor_meta_non_cached
        self._prop = None
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        outs = _tensors(out)
        for t in outs:
            self._hold(t)
        if func in FREE or func.is_view:
            return
        ins = _tensors((args, kwargs))
        w = self._weight
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVES.get(func._overloadpacket.__name__)
            if kind is None:        # wait_tensor
                return
            self.coll_bytes[kind] += w * sum(nbytes(t) for t in outs)
            self.n_coll[kind] += w
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += w * flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
        result = sum(nbytes(t) for t in outs)
        if func in COPIES and all(t.dtype == ins[0].dtype
                                  for t in ins + outs):
            return
        if func in GATHERS:
            traffic = 2.0 * result
        elif func in UPDATES:
            pos = UPDATES[func]
            upd = args[pos] if len(args) > pos else kwargs.get("values")
            traffic = 2.0 * (nbytes(upd) if isinstance(upd, torch.Tensor)
                             else result)
        else:
            traffic = result + sum(nbytes(t) for t in ins)
        self.traffic += w * traffic
        scores = flash_attention.plain_scores
        if scores is not None:
            self.score_traffic += w * sum(
                nbytes(t) for t in ins + outs
                if t.dim() >= 2 and tuple(t.shape[-2:]) == scores)

    def report(self) -> OpReport:
        return OpReport(flops=float(self.flops), traffic_bytes=self.traffic,
                        collective_bytes=dict(self.coll_bytes),
                        n_collectives=dict(self.n_coll),
                        score_traffic_bytes=self.score_traffic,
                        argument_bytes=self.argument_bytes,
                        peak_bytes=self.peak)

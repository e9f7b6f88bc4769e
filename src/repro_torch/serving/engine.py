"""The serving engine: one resident model, batched dispatch, optionally
sharded over a mesh.

A port of ``repro.serving.engine``.  One :class:`ServingEngine` owns one
estimator for the lifetime of the service, and dispatches the ring's
bucket-shaped :class:`TraceBatch` through ``model.estimate(...)``.

With a ``(data, model)`` mesh (``launch.mesh.make_local_mesh``; every
rank runs the service) the model is replicated as DTensors
(``model_api.device_resident``) and the trace axis of a bucket is split
over every mesh dimension, in row-major rank order: each rank scores its
rows on its local copy of the model, and the reports are gathered on
every rank.  Per-trace estimation is embarrassingly parallel; a box is
estimated with the window's ``config={"batch": ..., "first_trace": ...}``:
under ``impl='cuda'`` its charge kernels launch at the window's
geometry, under ``'vectorized'`` its row sums are taken at the window's
shape (``kernels.common.row_sums``), so the sharded result is the
one-process result bit for bit.
A mesh of one device, or a bucket whose trace count does not divide the
device count, takes the plain dispatch, as the reference's does.

The reference wraps the dispatch in ``jax.jit``; PyTorch compiles nothing
here.  :meth:`cache_size` counts the distinct ``(vendors, count bucket,
length bucket)`` shapes dispatched: the quantity the ring bounds, and the
counterpart of the reference's jit-cache size.
"""
from __future__ import annotations

from repro_torch.core import model_api
from repro_torch.core.dram import CommandTrace
from repro_torch.core.estimate_batch import TraceBatch


class ServingEngine:
    """Resident-model dispatcher over an optional ``(data, model)`` mesh.

    ``mode``/``impl``/fractions are fixed per engine (a service serves ONE
    estimation configuration); ``vendors`` varies per dispatch (vendor-
    subset requests are grouped by the ring)."""

    def __init__(self, model, *, mesh=None, impl: str = "vectorized",
                 mode: str = "mean", data=None, ones_frac=None,
                 toggle_frac=None):
        self.data = model_api.normalize_data_profile(data, ones_frac,
                                                     toggle_frac)
        model_api.validate_data_profile(mode, self.data)
        self.impl = model_api.resolve_impl(impl, mode=mode).name
        self.mode = mode
        self.ones_frac = self.data.ones_frac
        self.toggle_frac = self.data.toggle_frac
        self.mesh = mesh
        self.n_shards = 1 if mesh is None else mesh.size()
        self.last_rows: tuple | None = None   # rows of the last dispatch
        self._shapes: set[tuple] = set()
        self.update_model(model)

    @property
    def device(self):
        return self.local.device

    # ------------------------------------------------------------ dispatch
    def dispatch(self, tb: TraceBatch, vendors=None):
        """Score one bucket-shaped batch -> the model's report (leaves
        (traces, vendors)-shaped; mode='range' a (lo, mean, hi) triple).
        Shards the trace axis when the mesh has more than one device and
        the batch divides it (the module docstring says when the bits are
        the same either way)."""
        vendors = (tuple(int(v) for v in vendors)
                   if vendors is not None else None)
        self._shapes.add((vendors,) + tuple(tb.trace.cmd.shape))
        kw = dict(mode=self.mode, impl=self.impl, ones_frac=self.ones_frac,
                  toggle_frac=self.toggle_frac)
        self.last_rows = (0, tb.n_traces)
        if self.n_shards == 1 or tb.n_traces % self.n_shards:
            return self.local.estimate(tb, vendors, **kw)
        k = tb.n_traces // self.n_shards
        i = model_api.mesh_index(self.mesh, self.mesh.mesh_dim_names)
        rows = slice(i * k, (i + 1) * k)
        self.last_rows = (rows.start, rows.stop)
        box = TraceBatch(CommandTrace(*(x[rows] for x in tb.trace)),
                         tb.weight[rows])
        # a box's kernels launch at the whole window's geometry, and its
        # 'vectorized' row sums are taken at the window's shape
        whole = {"batch": (tb.n_traces, len(vendors or self.local.vendors)),
                 "first_trace": rows.start}
        rep = self.local.estimate(box, vendors, config=whole, **kw)
        dims = dict.fromkeys(self.mesh.mesh_dim_names, 0)
        return model_api.map_tensors(
            rep, lambda t: model_api.gather_boxes(t, self.mesh, dims))

    # ----------------------------------------------------------- lifecycle
    def cache_size(self) -> int:
        """Distinct (vendors, count, length) batch shapes dispatched."""
        return len(self._shapes)

    def update_model(self, model) -> None:
        """Swap in updated parameters (the online-recalibration hook), on
        the resident model's device and mesh."""
        if getattr(self, "local", None) is not None:
            model = model.to(self.device)
        self.resident = model_api.device_resident(model, self.mesh)
        self.local = model_api.local_view(self.resident)

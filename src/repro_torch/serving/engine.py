"""The serving engine: one resident model, batched dispatch.

A port of ``repro.serving.engine``.  One :class:`ServingEngine` owns one
estimator on its device for the lifetime of the service, and dispatches
the ring's bucket-shaped :class:`TraceBatch` through
``model.estimate(...)``.

The reference wraps the dispatch in ``jax.jit`` (and ``shard_map`` over
the trace axis on a multi-device mesh); PyTorch compiles nothing here and
one card has no mesh, so the engine calls the model directly.
:meth:`cache_size` counts the distinct ``(vendors, count bucket, length
bucket)`` shapes dispatched: the quantity the ring bounds, and the
counterpart of the reference's jit-cache size.
"""
from __future__ import annotations

from repro_torch.core import model_api
from repro_torch.core.estimate_batch import TraceBatch


class ServingEngine:
    """Resident-model dispatcher.

    ``mode``/``impl``/fractions are fixed per engine (a service serves ONE
    estimation configuration); ``vendors`` varies per dispatch (vendor-
    subset requests are grouped by the ring)."""

    def __init__(self, model, *, impl: str = "vectorized",
                 mode: str = "mean", data=None, ones_frac=None,
                 toggle_frac=None):
        self.data = model_api.normalize_data_profile(data, ones_frac,
                                                     toggle_frac)
        model_api.validate_data_profile(mode, self.data)
        self.impl = model_api.resolve_impl(impl, mode=mode).name
        self.mode = mode
        self.ones_frac = self.data.ones_frac
        self.toggle_frac = self.data.toggle_frac
        self.resident = model
        self._shapes: set[tuple] = set()

    @property
    def device(self):
        return self.resident.device

    # ------------------------------------------------------------ dispatch
    def dispatch(self, tb: TraceBatch, vendors=None):
        """Score one bucket-shaped batch -> the model's report (leaves
        (traces, vendors)-shaped; mode='range' a (lo, mean, hi) triple)."""
        vendors = (tuple(int(v) for v in vendors)
                   if vendors is not None else None)
        self._shapes.add((vendors,) + tuple(tb.trace.cmd.shape))
        return self.resident.estimate(
            tb, vendors, mode=self.mode, impl=self.impl,
            ones_frac=self.ones_frac, toggle_frac=self.toggle_frac)

    # ----------------------------------------------------------- lifecycle
    def cache_size(self) -> int:
        """Distinct (vendors, count, length) batch shapes dispatched."""
        return len(self._shapes)

    def update_model(self, model) -> None:
        """Swap in updated parameters (the online-recalibration hook), on
        the resident model's device."""
        self.resident = model.to(self.device)

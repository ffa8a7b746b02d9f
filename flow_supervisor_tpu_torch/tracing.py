"""Spans: named ranges at the port's layer boundaries, for the profiler.

    from flow_supervisor_tpu_torch.tracing import span

    with span("fst.lookup"):
        ...

    @span("fst.features")
    def features(...): ...

While a profiler runs (``torch.profiler.profile``, the train CLI's
``--trace_dir``, ``torch.autograd.profiler.emit_nvtx``), a span opens a
range on the profiler's own clock, beside every kernel, copy and runtime
call it records: the chrome trace shows it, Nsight shows it as an NVTX
range, and a reduction of the profiler's events can file each device
operation under the spans open at its launch. While none runs, ``span``
returns the name's shared no-op after one flag check, so a span costs a
function call.

The range is a ``RecordFunction`` of the function scope (the one an ATen op
opens), not a user annotation: the profiler copies a user annotation onto
the device's timeline as an event of its own, which a reduction of the
device's operations would count as a kernel. A span launches nothing and
records nothing on the device.

``host``, a dict, adds the span's host seconds under its short name (the
part after the last dot), profiler or not: the Evaluator's per-pair host
timers are spans.

Every name is in ``SPANS``; spans nest, and a span's device time counts the
spans inside it:

- ``fst.forward``: ``RAFT._flow``, the standard forward (inference and the
  Baseline step), and inside every forward of the model:
  ``fst.features`` (fnet), ``fst.context`` (cnet), ``fst.build_corr``
  (the correlation pyramid), ``fst.attention`` (GMA's attention map; empty
  in the other models), and in each refinement iteration ``fst.lookup``
  (the pyramid lookup) and ``fst.update`` (the update block or the teacher
  head; GMA's ``fst.aggregate`` inside it), and ``fst.upsample`` (each
  upsampled flow);
- the Evaluator's pair: ``fst.eval.decode`` (``load_record``),
  ``fst.eval.pad`` (the pad spec, ``np.pad`` and the copies to the card),
  ``fst.eval.forward`` (the model's dispatch, the teacher split
  included), ``fst.eval.fetch`` (the flows' copies to the host and the
  unpadding: the wait for the card lands here), and ``fst.warm_start``
  (``forward_interpolate``'s splat on the host);
- the train step: ``fst.train.h2d`` (the batch's copy to the card),
  ``fst.train.forward`` (the step's forwards, student and teacher),
  ``fst.train.loss``, ``fst.train.backward`` (``state.grads_of``) and
  ``fst.train.optimizer`` (``TrainState.apply_gradients``: ``AdamW.update``
  and the parameters' adds).
"""
from __future__ import annotations

import functools
import time

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

SPANS = (
    "fst.forward", "fst.features", "fst.context", "fst.build_corr", "fst.attention",
    "fst.lookup", "fst.update", "fst.aggregate", "fst.upsample",
    "fst.eval.decode", "fst.eval.pad", "fst.eval.forward", "fst.eval.fetch", "fst.warm_start",
    "fst.train.h2d", "fst.train.forward", "fst.train.loss", "fst.train.backward",
    "fst.train.optimizer",
)


class _Off:
    """A span while no profiler runs and no host timer is asked for; also a
    decorator, which opens ``span(name)`` at every call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            if not _profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _On(name, None):
                return fn(*args, **kwargs)

        return spanned


_OFF = {name: _Off(name) for name in SPANS}


class _On(_Off):
    """A span with a profiler's range, a host timer, or both."""

    __slots__ = ("host", "_range", "_t0")

    def __init__(self, name: str, host):
        super().__init__(name)
        self.host, self._range, self._t0 = host, None, 0.0

    def __enter__(self):
        if _profiler._is_profiler_enabled:
            self._range = _RecordFunctionFast(self.name)
            self._range.__enter__()
        if self.host is not None:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.host is not None:
            key = self.name.rsplit(".", 1)[1]
            self.host[key] = self.host.get(key, 0.0) + time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        return None


def span(name: str, host: dict | None = None):
    """The span ``name`` (one of ``SPANS``), a context manager or a
    decorator: the name's shared no-op while no profiler runs and ``host``
    is None."""
    off = _OFF.get(name)
    if off is None:
        raise ValueError(f"span {name!r}: not one of tracing.SPANS")
    if host is None and not _profiler._is_profiler_enabled:
        return off
    return _On(name, host)

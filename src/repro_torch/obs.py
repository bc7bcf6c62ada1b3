"""Spans at the port's layer boundaries, for the profiler and a Recorder.

    with obs.span("step.encode"):
        ...

A span has two listeners, each on only while it listens:

* torch.profiler: while the profiler records in this thread (torch's
  Python flag `torch.autograd.profiler._is_profiler_enabled`, which
  torch.profiler sets, then `torch._C._autograd._profiler_enabled()`),
  the span opens a `record_function` range of its name.  The range
  lands in the profiler's host timeline, on the clock of the device
  activity it traces, so a reader can name the kernels launched inside
  it and the idle gaps that open inside it.
* a Recorder: while one is entered in the calling context, the span adds
  one count and its host seconds (`time.perf_counter`; no device
  synchronise, so a span that launches kernels times their launch) under
  its path, the names of the open spans joined by "/", such as
  `train.step/step.encode/random.threefry`.  The path keeps the span
  that caused each one: a draw in set-up and a draw in a step add to two
  totals.

With neither listening, `span` reads one context variable and one module
attribute and returns a shared null context: it allocates nothing, makes
no C call and builds no `record_function` (an idle one costs ~8 us on
the host).  Span names hold no "/".
"""

from __future__ import annotations

import contextvars
import time

import torch
import torch.autograd.profiler as _autograd_profiler


class _Off:
    """The shared null context of a span nobody listens to."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return False


_OFF = _Off()
_RECORDER: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_obs_recorder", default=None)
_profiler_enabled = torch._C._autograd._profiler_enabled


def _profiling() -> bool:
    return _autograd_profiler._is_profiler_enabled and _profiler_enabled()


def span(name: str):
    """A context manager around one phase; see the module's docstring."""
    rec = _RECORDER.get()
    if rec is None:
        # _profiling(), inline: the off path makes no call
        if not (_autograd_profiler._is_profiler_enabled
                and _profiler_enabled()):
            return _OFF
        return _autograd_profiler.record_function(name)
    return _Span(rec, name)


class Recorder:
    """Totals of the spans opened in this context while it is entered:
    `spans` = {path: [count, seconds]}, in the order the paths first
    closed.  A Recorder entered inside another takes the spans until it
    exits; their paths start at its own outermost span."""

    def __init__(self):
        self.spans: dict = {}
        self._open: list = []         # paths of the spans open now
        self._token = None

    def __enter__(self) -> "Recorder":
        self._token = _RECORDER.set(self)
        return self

    def __exit__(self, *exc) -> bool:
        _RECORDER.reset(self._token)
        return False


class _Span:
    __slots__ = ("rec", "name", "path", "range", "t0")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name
        self.range = _autograd_profiler.record_function(name) \
            if _profiling() else None

    def __enter__(self):
        if self.range is not None:
            self.range.__enter__()
        opened = self.rec._open
        self.path = f"{opened[-1]}/{self.name}" if opened else self.name
        opened.append(self.path)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter() - self.t0
        self.rec._open.pop()
        total = self.rec.spans.get(self.path)
        if total is None:
            self.rec.spans[self.path] = [1, dt]
        else:
            total[0] += 1
            total[1] += dt
        if self.range is not None:
            self.range.__exit__(*exc)
        return False

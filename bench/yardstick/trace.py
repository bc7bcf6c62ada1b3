"""Spans around the calls into the program's layers, and the reduction of a
`torch.profiler` trace to what the per-layer metrics read.

Spans are `record_function` ranges that the benchmark opens itself: while a
`Spans` block is active, each named callable of the program is replaced by
a wrapper that opens a range of the given name around the call.  Nothing
inside the program is changed.

`DeviceTrace` records one stretch of a run (CPU and CUDA activity) and
keeps, from the profiler's events, the device operations (kernels, copies,
sets), the runtime calls that launched them (linked by correlation id), the
benchmark's ranges and the host's operations.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import re

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CALL = re.compile(r"^cu(da)?[A-Z]")


class Spans(contextlib.AbstractContextManager):
    """Wrap `getattr(owner, attr)` in a range named `span` for each
    (owner, attr, span) of `targets`, and restore them on exit."""

    def __init__(self, targets):
        self.targets = list(targets)
        self._saved = []

    def __enter__(self):
        for owner, attr, span in self.targets:
            orig = owner.__dict__[attr] if isinstance(owner, type) \
                else getattr(owner, attr)
            self._saved.append((owner, attr, orig))
            setattr(owner, attr, _wrapped(orig, span))
        return self

    def __exit__(self, *exc):
        while self._saved:
            owner, attr, orig = self._saved.pop()
            setattr(owner, attr, orig)
        return False


def _wrapped(fn, span: str):
    def call(*args, **kw):
        with record_function(span):
            return fn(*args, **kw)
    call.__wrapped__ = fn
    return call


def span(name: str):
    """A range opened by the benchmark's own code."""
    return record_function(name)


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    initialisation) falls in set-up and not in the traced stretch."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class DeviceTrace:
    """One traced stretch: `start()`, the work, `stop()` -> self."""

    def __init__(self):
        self._prof = None
        self.device_ops = []      # (start_ns, end_ns, name, corr, kind)
        self.launch_ns = {}       # corr -> start of the runtime call
        self.ranges = collections.defaultdict(list)   # name -> [(s, e)]
        self.host = []            # (start_ns, end_ns, name), sorted

    def start(self) -> "DeviceTrace":
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def stop(self) -> "DeviceTrace":
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.ingest(self._prof.profiler.kineto_results.events())
        self._prof = None
        return self

    def ingest(self, events) -> None:
        events = list(events)
        marks = {e.name() for e in events if e.is_user_annotation()}
        for e in events:
            kind = _kind(e, marks)
            start, dur = e.start_ns(), e.duration_ns()
            if kind in DEVICE_KINDS:
                self.device_ops.append((start, start + dur, e.name(),
                                        e.correlation_id(), kind))
            elif kind in ("cuda_runtime", "cuda_driver"):
                self.launch_ns[e.correlation_id()] = start
            elif kind == "user_annotation":
                self.ranges[e.name()].append((start, start + dur))
                self.host.append((start, start + dur, e.name()))
            elif kind == "cpu_op":
                self.host.append((start, start + dur, e.name()))
        self.device_ops.sort()
        self.host.sort()
        for spans in self.ranges.values():
            spans.sort()

    # ------------------------------------------------------------ readings

    def window(self, name: str) -> tuple | None:
        spans = self.ranges.get(name)
        if not spans:
            return None
        return spans[0][0], spans[-1][1]

    def busy_ns(self, lo: int, hi: int) -> int:
        """Length of the union of device operations, clipped to [lo, hi]."""
        total, cur_s, cur_e = 0, None, None
        for s, e, *_ in self.device_ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total

    def _in_ranges(self, name: str, t: int) -> bool:
        spans = self.ranges.get(name, ())
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        return i >= 0 and spans[i][0] <= t <= spans[i][1]

    def ops_launched_in(self, name: str) -> list:
        """Kernels whose launching runtime call lies inside a range called
        `name`."""
        out = []
        for op in self.device_ops:
            t = self.launch_ns.get(op[3])
            if t is not None and op[4] == "kernel" and \
                    self._in_ranges(name, t):
                out.append(op)
        return out

    def linked_share(self) -> float:
        """Share of device operations whose launching call was found."""
        if not self.device_ops:
            return 0.0
        found = sum(op[3] in self.launch_ns for op in self.device_ops)
        return found / len(self.device_ops)

    def device_seconds_by_name(self, lo: int, hi: int, top: int = 10):
        acc = collections.Counter()
        for s, e, name, *_ in self.device_ops:
            s, e = max(s, lo), min(e, hi)
            if e > s:
                acc[name] += (e - s) * 1e-9
        return [[n, v] for n, v in acc.most_common(top)]

    def idle_gaps(self, lo: int, hi: int, top: int = 10):
        """The longest gaps with no device operation inside [lo, hi], each
        named by the innermost host range or operation open at its start."""
        gaps, cur = [], lo
        for s, e, *_ in self.device_ops:
            if e <= lo or s >= hi:
                continue
            if s > cur:
                gaps.append((s - cur, cur))
            cur = max(cur, e)
        if hi > cur:
            gaps.append((hi - cur, cur))
        gaps.sort(reverse=True)
        return [[f"host: {self.host_at(t)}", g * 1e-9] for g, t in gaps[:top]]

    def host_at(self, t: int) -> str:
        i = bisect.bisect_right(self.host, (t, float("inf"), "")) - 1
        for j in range(i, max(-1, i - 5000), -1):
            s, e, name = self.host[j]
            if s <= t < e:
                return name
        return "idle"


def _kind(e, marks) -> str:
    """The profiler's activity type of an event, from its device, its
    annotation flag and its name (runtime calls are named cuda* / cu*):
    torch's `_KinetoEvent` does not give the type itself."""
    name = e.name()
    on_device = e.device_type() != torch.autograd.DeviceType.CPU
    if e.is_user_annotation() or (on_device and name in marks):
        return "gpu_user_annotation" if on_device else "user_annotation"
    if on_device:
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "cuda_runtime" if RUNTIME_CALL.match(name) else "cpu_op"

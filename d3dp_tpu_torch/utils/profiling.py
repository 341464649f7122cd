"""Profiling: a torch.profiler trace around a block of code, and the
program's own spans and counters.

`trace` is the counterpart of d3dp_tpu/utils/profiling.py's (there a
jax.profiler trace; the command line's `--profile DIR` wraps the first
training epoch or the first evaluated action in it).

`span` and `count` mark the boundaries of the port's layers: the
Evaluator's call, micro-batch, feed, scoring and reads, `D3DP.sample` and
each DDIM step, the train step's phases, the Prefetcher's wait, and every
call site that makes the host wait for the device (`host_syncs`). They
record while a torch profiler records, and only then: outside one a span
or a count costs one flag read. Their times are `time.time_ns()`, the
epoch on which the profiler stamps its host and device events, so a span
can be laid against the device trace; each span also enters
`record_function("d3dp." + name)`, which shows it in the exported trace.
A span given a device records a CUDA event at entry and at exit; the
device time between them is read only when the spans are read. Inside the
ops one counter records: `linear_tf32x3`, each launch of the block
linears' tf32x3 GEMM (`ops.linear.gemm`), which shows how often that path
engages (128 a composed fp32 train step at the published depth, none in
evaluation at fuse levels 1-5). No other op or kernel wrapper records.
"""

import contextlib
import itertools
import json
import os
import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

PREFIX = "d3dp."


def recording():
    """Whether a torch profiler is recording: the recorder records then
    only."""
    return _autograd_profiler._is_profiler_enabled


class _Span:
    __slots__ = ("recorder", "id", "name", "parent", "thread", "unit", "start_ns", "end_ns",
                 "sync", "stream", "events", "device_ms", "_annotation")

    def __init__(self, recorder, name, unit, device, sync):
        self.recorder, self.name, self.sync = recorder, name, sync
        self.unit, self.device_ms, self.events = unit, None, None
        device = torch.device(device) if device is not None else None
        self.stream = (torch.cuda.current_stream(device)
                       if device is not None and device.type == "cuda" else None)

    def __enter__(self):
        stack = self.recorder._stack()
        parent = stack[-1] if stack else None
        self.id = next(self.recorder._ids)
        self.parent = None if parent is None else parent.id
        inherited = None if parent is None else parent.unit
        self.unit = inherited if self.unit is None else (inherited or ()) + (self.unit,)
        self.thread = threading.get_ident()
        self.start_ns = time.time_ns()
        self._annotation = record_function(PREFIX + self.name)
        self._annotation.__enter__()
        if self.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        self._annotation.__exit__(None, None, None)
        self.end_ns = time.time_ns()
        self.recorder._stack().pop()
        self.recorder._done.append(self)
        return False

    def as_dict(self):
        if self.events is not None:
            self.events[1].synchronize()
            self.device_ms = self.events[0].elapsed_time(self.events[1])
            self.events = self.stream = None
        return {"id": self.id, "name": self.name, "parent": self.parent,
                "thread": self.thread, "unit": None if self.unit is None else list(self.unit),
                "start_ns": self.start_ns, "end_ns": self.end_ns, "sync": self.sync,
                "device_ms": self.device_ms}


class Recorder:
    """Spans and counters, kept in memory until read or reset.

    A span's parent is the innermost span open on the same thread; its
    unit identifies the work it belongs to (a call, a micro-batch, a step):
    the parent's unit, extended by the span's own `unit` where one is
    given, so every span of one micro-batch starts with the micro-batch's
    unit. A counter is kept as its increments with their times, so it can
    be summed over a window."""

    def __init__(self):
        self._local = threading.local()
        self._ids = itertools.count()
        self._done = []  # finished spans
        self._counts = []  # (name, time_ns, n)

    def _stack(self):
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name, unit=None, device=None, sync=False):
        """A context manager that records the block as the span `name`
        while a profiler records. `device`: the torch.device whose work the
        span also times by CUDA events (none on a CPU device); `sync`: the
        block makes the host wait for the device."""
        if not recording():
            return contextlib.nullcontext()
        return _Span(self, name, unit, device, sync)

    def count(self, name, n=1):
        """Add n to the counter `name` while a profiler records."""
        if recording():
            self._counts.append((name, time.time_ns(), n))

    def spans(self):
        """The finished spans, by start: dicts of id, name, parent (its id),
        thread, unit (a list, or None), start_ns, end_ns, sync and
        device_ms (None without a device)."""
        return sorted((s.as_dict() for s in list(self._done)),
                      key=lambda d: (d["start_ns"], d["id"]))

    def counters(self, start_ns=None, end_ns=None):
        """{name: total} of the increments made in [start_ns, end_ns)
        (every one by default)."""
        out = {}
        for name, t, n in list(self._counts):
            if (start_ns is None or t >= start_ns) and (end_ns is None or t < end_ns):
                out[name] = out.get(name, 0) + n
        return out

    def reset(self):
        self._done.clear()
        self._counts.clear()


RECORDER = Recorder()
span, count = RECORDER.span, RECORDER.count
spans, counters, reset = RECORDER.spans, RECORDER.counters, RECORDER.reset


def count_uploads(device, *arrays):
    """Count a host sync for each of `arrays` that is not a tensor on
    `device`'s kind of device already: its copy there, from pageable host
    memory, waits for the device."""
    if recording():
        kind = torch.device(device).type
        count("host_syncs", sum(not (isinstance(a, torch.Tensor) and a.device.type == kind)
                                for a in arrays))


@contextlib.contextmanager
def trace(logdir, enabled=True):
    """Profile the block (host and, where a card is present, device
    activity) and write a Chrome trace to `logdir/trace.json`, which
    chrome://tracing and Perfetto open, and the program's spans (each with
    its device ms) and counters of the block to `logdir/program.json`."""
    if not enabled:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "program.json"), "w") as f:
        json.dump({"spans": spans(), "counters": counters()}, f)

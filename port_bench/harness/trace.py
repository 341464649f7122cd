"""Spans around the calls into each layer, and the device trace of a
`--trace 1` run.

Every run keeps its spans on the host clock (`Spans`); a traced run also
marks each span as a torch.profiler user annotation and records the
device's operations over the measured window (`Tracer`). The trace is read
from the profiler's raw events (no per-event post-processing), as
`TraceData`: the device operations in the window, the harness's host spans,
the busy time (the union of the operations' intervals) and the gaps.
"""

import contextlib
import time
from dataclasses import dataclass, field

PREFIX = "port_bench."


class Spans:
    """Host-clock spans by name: {name: [(start_s, end_s)]}."""

    def __init__(self, annotate=False):
        self.spans = {}
        self._annotate = annotate

    @contextlib.contextmanager
    def span(self, name):
        t0 = time.perf_counter()
        if self._annotate:
            from torch.profiler import record_function

            with record_function(PREFIX + name):
                yield
        else:
            yield
        self.spans.setdefault(name, []).append((t0, time.perf_counter()))

    def durations_ms(self, name):
        return [1e3 * (b - a) for a, b in self.spans.get(name, [])]


@dataclass
class TraceData:
    ops: list = field(default_factory=list)  # [(name, start_ns, end_ns)], device, by start
    host: list = field(default_factory=list)  # [(span name, start_ns, end_ns)]
    window_ns: tuple = (0, 0)

    @property
    def window_s(self):
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_ns(self):
        """The union of the device operations' intervals."""
        busy, end = 0, None
        for _, a, b in self.ops:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        return busy

    def gaps(self):
        """[(start_ns, end_ns)] of the window's intervals with no device
        operation."""
        out, cursor = [], self.window_ns[0]
        for _, a, b in self.ops:
            if a > cursor:
                out.append((cursor, a))
            cursor = max(cursor, b)
        if self.window_ns[1] > cursor:
            out.append((cursor, self.window_ns[1]))
        return out

    def host_span_at(self, t_ns):
        """The innermost harness span open on the host at t_ns, or None."""
        best = None
        for name, a, b in self.host:
            if a <= t_ns < b and (best is None or a >= best[1]):
                best = (name, a)
        return None if best is None else best[0]

    def breakdown(self, top=10):
        """{"device_ops": [[name, s]], "idle_gaps": [[host span, s]]}: the
        device operations that took most time, summed by name, and the
        longest idle gaps by what the host was doing."""
        by_name = {}
        for name, a, b in self.ops:
            by_name[name] = by_name.get(name, 0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], v / 1e9] for n, v in ops],
                "idle_gaps": [[self.host_span_at(a) or "none", (b - a) / 1e9]
                              for a, b in gaps]}


class Tracer:
    """The profiler over the measured window of a traced run; a no-op
    otherwise."""

    def __init__(self, enabled):
        self.enabled = enabled
        self.data = None

    def warm_up(self, torch):
        """Start and stop the profiler once in set-up: its first start
        initialises the device tracer."""
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def window(self, torch):
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function(PREFIX + "window"):
                yield
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        self.data = read_events(torch, prof)


def read_events(torch, prof):
    """TraceData from a finished profile's raw events."""
    cuda = torch.autograd.DeviceType.CUDA
    ops, host, window = [], [], (0, 0)
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            if e.is_user_annotation():
                continue
            ops.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
        elif e.is_user_annotation() and name.startswith(PREFIX):
            span = (name[len(PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
            if span[0] == "window":
                window = span[1:]
            else:
                host.append(span)
    # the window ends after a synchronise, so every operation of the window
    # lies in it; clip the few nanoseconds the two clocks may disagree by
    ops = sorted(((n, max(a, window[0]), min(b, window[1])) for n, a, b in ops
                  if a < window[1] and b > window[0]), key=lambda o: (o[1], o[2]))
    return TraceData(ops=ops, host=host, window_ns=window)

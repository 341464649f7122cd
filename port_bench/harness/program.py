"""The program's own spans and counters (d3dp_tpu_torch/utils/profiling.py),
recorded while the traced window's profiler ran, as the per-layer readers
take them: those of the window, and the innermost span open on the host
when each idle gap of the device trace opened.

A checkout whose program records no spans gives None throughout, and its
readers report nothing.
"""


def recorded(trace):
    """(spans, counters) of the window: the spans that started in it (the
    recorder's dicts, by start) and the counters' increments made in it; None
    without a trace, or where the program has no recorder or recorded
    nothing."""
    if trace is None:
        return None
    try:
        from d3dp_tpu_torch.utils import profiling

        read_spans, read_counters = profiling.spans, profiling.counters
    except (ImportError, AttributeError):
        return None
    a, b = trace.window_ns
    spans = [s for s in read_spans() if a <= s["start_ns"] < b]
    if not spans:
        return None
    return spans, read_counters(a, b)


def named(spans, name):
    return [s for s in spans if s["name"] == name]


def mean_device_ms(spans, name, per=None):
    """The spans' summed device ms over their number (or over `per`); None
    where there is none or one lacks a device time."""
    ms = [s["device_ms"] for s in named(spans, name)]
    if not ms or any(v is None for v in ms):
        return None
    return sum(ms) / (per or len(ms))


def idle_by_span(trace, spans):
    """{span name or None: idle ns} of the window's gaps, each put down to
    the innermost program span open when it opened. One sweep over the
    gaps and the spans, both by start."""
    out, open_, i = {}, [], 0
    for a, b in trace.gaps():
        while i < len(spans) and spans[i]["start_ns"] <= a:
            open_.append(spans[i])
            i += 1
        open_ = [s for s in open_ if s["end_ns"] > a]
        name = open_[-1]["name"] if open_ else None
        out[name] = out.get(name, 0) + (b - a)
    return out


def sync_idle_share(ctx):
    """100 x the idle time of the window's gaps that opened inside a span
    marked `sync` (the host waiting for the device), over the window."""
    got = recorded(ctx.trace)
    if got is None or not ctx.trace.ops or ctx.trace.window_s <= 0:
        return None
    spans = got[0]
    sync = {s["name"] for s in spans if s["sync"]}
    idle = idle_by_span(ctx.trace, spans)
    return 100.0 * sum(v for k, v in idle.items() if k in sync) / 1e9 / ctx.trace.window_s


def per_unit(ctx, counter, unit_span):
    """The counter's increments in the window over the window's spans named
    `unit_span` (micro-batches, steps)."""
    got = recorded(ctx.trace)
    if got is None:
        return None
    spans, counts = got
    n = len(named(spans, unit_span))
    return counts.get(counter, 0) / n if n else None

"""The Evaluator's feed of a micro-batch on the host: the mean host-clock ms
of the window's `eval.feed` spans (slicing, padding, every host-to-device
copy, each of which waits for the device)."""

from port_bench.harness.program import named, recorded


def read(ctx):
    got = recorded(ctx.trace)
    feeds = [] if got is None else named(got[0], "eval.feed")
    return sum(s["end_ns"] - s["start_ns"] for s in feeds) / len(feeds) / 1e6 if feeds else None

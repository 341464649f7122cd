"""The train loop's gets from the Prefetcher that found its queue empty:
100 x the program's `prefetch.starved` over `prefetch.gets` in the window."""

from port_bench.harness.program import recorded


def read(ctx):
    got = recorded(ctx.trace)
    if got is None or not got[1].get("prefetch.gets"):
        return None
    return 100.0 * got[1].get("prefetch.starved", 0) / got[1]["prefetch.gets"]

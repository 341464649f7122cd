"""The train loop's wait for a batch: the mean host-clock time of each
`next()` on the Prefetcher in the window."""


def read(ctx):
    ms = ctx.counts["batch_wait_ms"]
    return sum(ms) / len(ms) if ms else None

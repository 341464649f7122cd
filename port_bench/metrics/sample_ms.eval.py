"""`D3DP.sample`'s device span, the mean over the window's calls: CUDA
events recorded at each call and at its return, so the span runs from the
device reaching the call's first operation to its last."""


def read(ctx):
    ms = ctx.counts["sample_ms"]
    return sum(ms) / len(ms) if ms else None

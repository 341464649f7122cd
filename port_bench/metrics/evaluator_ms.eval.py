"""The Evaluator's host time a micro-batch outside `D3DP.sample`: the mean,
over the window's micro-batches, of the host-clock time from a `sample`
call's return to the next call (scoring, host copies, windowing, the
backpressure read, the report between actions)."""


def read(ctx):
    ms = ctx.counts["evaluator_ms"]
    return sum(ms) / len(ms) if ms else None

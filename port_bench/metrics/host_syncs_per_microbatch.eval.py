"""Host waits for the device per micro-batch: the program's `host_syncs`
counter (every call that makes the host wait: copies from host memory,
reads of device values, waits) over the window's `eval.microbatch` spans,
the reads of each evaluation's result included."""

from port_bench.harness.program import per_unit


def read(ctx):
    return per_unit(ctx, "host_syncs", "eval.microbatch")

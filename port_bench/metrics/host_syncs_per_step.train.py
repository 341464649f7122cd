"""Host waits for the device per train step: the program's `host_syncs`
counter over the window's `train.step` spans."""

from port_bench.harness.program import per_unit


def read(ctx):
    return per_unit(ctx, "host_syncs", "train.step")

"""The train step's forward phase on the device: the device ms (CUDA events
recorded by the program) of the window's `train.forward` spans, a step."""

from port_bench.harness.program import mean_device_ms, named, recorded


def read(ctx):
    got = recorded(ctx.trace)
    if got is None:
        return None
    return mean_device_ms(got[0], "train.forward", per=len(named(got[0], "train.step")))

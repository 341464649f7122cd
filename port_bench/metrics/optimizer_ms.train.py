"""The train step's optimizer phase on the device: the device ms (CUDA events
recorded by the program) of the window's `train.optimizer` spans, a step."""

from port_bench.harness.program import mean_device_ms, named, recorded


def read(ctx):
    got = recorded(ctx.trace)
    if got is None:
        return None
    return mean_device_ms(got[0], "train.optimizer", per=len(named(got[0], "train.step")))

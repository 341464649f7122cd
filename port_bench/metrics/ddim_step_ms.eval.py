"""One DDIM step of `D3DP.sample` on the device: the mean device ms (CUDA
events at the step's entry and exit, recorded by the program) of the
window's `sample.step` spans."""

from port_bench.harness.program import mean_device_ms, recorded


def read(ctx):
    got = recorded(ctx.trace)
    return None if got is None else mean_device_ms(got[0], "sample.step")

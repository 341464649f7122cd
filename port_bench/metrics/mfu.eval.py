"""The whole sampler's share of the chip's peak in the eval cells: the
model's forward operations on the real windows of the counted
micro-batches (each window's H hypotheses and their flipped copies, K
forwards each) over the window's seconds and the dtype's peak
(harness/peaks.py). A forward's operations are the architecture's
(`forward_flops`, port_bench/arch/)."""

from port_bench.arch import architecture
from port_bench.harness.peaks import PEAK_FLOPS


def read(ctx):
    windows = ctx.counts["real_windows"]
    if not windows or ctx.window_s <= 0 or ctx.run.device.type != "cuda":
        return None
    m = ctx.config["model"]
    flops = (windows * ctx.counts["real_rows_per_window"] * ctx.traffic["sampling_timesteps"]
             * architecture(m).forward_flops(m))
    return 100.0 * flops / ctx.window_s / PEAK_FLOPS[ctx.dtype]

"""The whole training step's share of the chip's peak in the train cell:
three times the forward operations (forward, and the backward's two
products a forward product) of the real chunks of the counted steps over
the window's seconds and the dtype's peak (harness/peaks.py). A forward's
operations are the architecture's (`forward_flops`, port_bench/arch/)."""

from port_bench.arch import architecture
from port_bench.harness.peaks import PEAK_FLOPS


def read(ctx):
    chunks = ctx.counts["real_chunks"]
    if not chunks or ctx.window_s <= 0 or ctx.run.device.type != "cuda":
        return None
    m = ctx.config["model"]
    return 100.0 * 3 * chunks * architecture(m).forward_flops(m) / ctx.window_s / \
        PEAK_FLOPS[ctx.dtype]

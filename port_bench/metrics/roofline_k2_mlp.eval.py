"""K2's share of its roofline in the eval cells: the least time of every
MLP block (ops/csrc/mlp_block_t.cu, one launch a call) over the summed
device time of its launches. A call on T tokens of width C and hidden
width Hd computes fc1 and fc2 (4*T*C*Hd); it reads y2 and x2 and writes
its output (3*T*C elements), reads both weight matrices (2*C*Hd) and the
fp32 vectors (Hd + 3*C). A forward makes one call a block, spatial or
temporal, of the architecture's `blocks` (port_bench/arch/).
"""

from port_bench.arch import architecture
from port_bench.harness.kernels import by_prefix
from port_bench.harness.peaks import ITEMSIZE, bound_s


def flops_bytes(T, C, Hd, itemsize):
    return (4 * T * C * Hd, 3 * T * C * itemsize + 2 * C * Hd * itemsize + (Hd + 3 * C) * 4)


def call_bound_s(rows, frames, joints, C, Hd, dtype):
    """Least seconds of one K2 call on `rows` hypothesis rows (either
    direction: the same tokens)."""
    return bound_s(*flops_bytes(rows * frames * joints, C, Hd, ITEMSIZE[dtype]), dtype)


def read(ctx):
    if ctx.trace is None:
        return None
    m, K = ctx.config["model"], ctx.traffic["sampling_timesteps"]
    calls = ctx.counts["sample_calls"] * sum(architecture(m).blocks(m)) * K
    times = by_prefix(ctx.trace.ops, ("mlp_block_kernel",))["mlp_block_kernel"]
    if calls == 0 or len(times) != calls:
        return None
    hidden = int(m["embed_dim"] * m["mlp_ratio"])
    bound = calls * call_bound_s(ctx.counts["rows"], m["num_frames"], m["num_joints"],
                                 m["embed_dim"], hidden, ctx.dtype)
    return 100.0 * bound / sum(times)

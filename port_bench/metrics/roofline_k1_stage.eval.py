"""K1's share of its roofline in the eval cells: the least time of every
K1 call the window ran (ops/csrc/attention_stage.cu: ln_qkv, attend,
proj_ln2, three launches a call) over the summed device time of its
launches. A call on R sequences of N tokens of width C computes the qkv
product (2*T*C*3C, T = R*N), attention (4*T*N*C) and the projection
(2*T*C*C); it reads x and writes x2 and y2 (3*T*C elements), reads the
two weight matrices (4*C*C) and eight fp32 vectors of C. A forward makes
one call a block, spatial or temporal, of the architecture's `blocks`
(port_bench/arch/).
"""

from port_bench.arch import architecture
from port_bench.harness.kernels import by_prefix
from port_bench.harness.peaks import ITEMSIZE, bound_s

LAUNCHES = ("ln_qkv_walk", "attend_", "proj_ln2_walk")


def flops_bytes(R, N, C, itemsize):
    T = R * N
    return (2 * T * C * 3 * C + 4 * T * N * C + 2 * T * C * C,
            3 * T * C * itemsize + 4 * C * C * itemsize + 8 * C * 4)


def call_bounds_s(rows, frames, joints, C, dtype):
    """(spatial, temporal) least seconds of one K1 call on `rows`
    hypothesis rows."""
    item = ITEMSIZE[dtype]
    return (bound_s(*flops_bytes(rows * frames, joints, C, item), dtype),
            bound_s(*flops_bytes(rows * joints, frames, C, item), dtype))


def read(ctx):
    if ctx.trace is None:
        return None
    m = ctx.config["model"]
    spatial, temporal = architecture(m).blocks(m)
    forwards = ctx.counts["sample_calls"] * ctx.traffic["sampling_timesteps"]
    per_name = forwards * (spatial + temporal)
    times = by_prefix(ctx.trace.ops, LAUNCHES)
    if per_name == 0 or any(len(v) != per_name for v in times.values()):
        return None  # a launch lost from the trace: no share of a partial sum
    sp, tp = call_bounds_s(ctx.counts["rows"], m["num_frames"], m["num_joints"],
                           m["embed_dim"], ctx.dtype)
    bound = forwards * (spatial * sp + temporal * tp)
    return 100.0 * bound / sum(sum(v) for v in times.values())

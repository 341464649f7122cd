"""K4's share of its roofline in the train cell: the least time of every
attention backward of the window's steps (ops/csrc/attention_qkv.cu) over
the summed device time of its launches. A call on R sequences of N tokens
(T = R*N) of width C recomputes S and forms dV, dP, dQ and dK (10*T*N*C);
it reads qkv and dO and writes dqkv (7*T*C elements). fp32 runs two
launches a call above 32 keys (the query and the key pass), one at 32 or
fewer; bf16 one. A step makes one call a block, spatial or temporal, of
the architecture's `blocks` (port_bench/arch/).
"""

from port_bench.arch import architecture
from port_bench.harness.kernels import by_prefix
from port_bench.harness.peaks import ITEMSIZE, bound_s


def flops_bytes(R, N, C, itemsize):
    T = R * N
    return 10 * T * N * C, 7 * T * C * itemsize


def launches(N, dtype):
    return 2 if dtype == "float32" and N > 32 else 1


def step_bound_s(batch, frames, joints, C, spatial, temporal, dtype):
    """Least seconds of one step's K4 calls: `spatial` on batch*frames
    sequences of `joints`, `temporal` on batch*joints of `frames`."""
    item = ITEMSIZE[dtype]
    return (spatial * bound_s(*flops_bytes(batch * frames, joints, C, item), dtype)
            + temporal * bound_s(*flops_bytes(batch * joints, frames, C, item), dtype))


def read(ctx):
    if ctx.trace is None:
        return None
    m, dt = ctx.config["model"], ctx.dtype
    steps = ctx.counts["steps"]
    times = by_prefix(ctx.trace.ops, ("attn_bwd_",))["attn_bwd_"]
    spatial, temporal = architecture(m).blocks(m)
    want = steps * (spatial * launches(m["num_joints"], dt)
                    + temporal * launches(m["num_frames"], dt))
    if steps == 0 or len(times) != want:
        return None
    bound = steps * step_bound_s(ctx.counts["batch"], m["num_frames"], m["num_joints"],
                                 m["embed_dim"], spatial, temporal, dt)
    return 100.0 * bound / sum(times)

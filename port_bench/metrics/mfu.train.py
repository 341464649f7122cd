"""The whole training step's share of the chip's peak in the train cell:
three times the forward operations (forward, and the backward's two
products a forward product) of the real chunks of the counted steps over
the window's seconds and the dtype's peak (harness/peaks.py)."""

from port_bench.harness.peaks import PEAK_FLOPS


def forward_flops(m):
    """Operations of one MixSTE2 forward on one (F, J) chunk (as
    mfu.eval's)."""
    C, Fr, J, depth = m["embed_dim"], m["num_frames"], m["num_joints"], m["depth"]
    hidden = int(C * m["mlp_ratio"])
    tokens = Fr * J
    per_token = 8 * C * C + 4 * C * hidden
    blocks = depth * tokens * (2 * per_token + 4 * J * C + 4 * Fr * C)
    return 2 * tokens * (m["in_chans"] + 3) * C + 8 * C * C + blocks + 2 * tokens * C * 3


def read(ctx):
    chunks = ctx.counts["real_chunks"]
    if not chunks or ctx.window_s <= 0 or ctx.run.device.type != "cuda":
        return None
    return 100.0 * 3 * chunks * forward_flops(ctx.config["model"]) / ctx.window_s / \
        PEAK_FLOPS[ctx.dtype]

"""The whole sampler's share of the chip's peak in the eval cells: the
model's forward operations on the real windows of the counted
micro-batches (each window's H hypotheses and their flipped copies, K
forwards each) over the window's seconds and the dtype's peak
(harness/peaks.py)."""

from port_bench.harness.peaks import PEAK_FLOPS


def forward_flops(m):
    """Operations of one MixSTE2 forward on one (F, J) row: the joint
    embedding, the time MLP, 2*depth blocks (qkv 6C^2, projection 2C^2,
    MLP 4*C*Hd a token, attention 4*N*C a token over N = J spatially and
    N = F temporally) and the head."""
    C, Fr, J, depth = m["embed_dim"], m["num_frames"], m["num_joints"], m["depth"]
    hidden = int(C * m["mlp_ratio"])
    tokens = Fr * J
    per_token = 8 * C * C + 4 * C * hidden
    blocks = depth * tokens * (2 * per_token + 4 * J * C + 4 * Fr * C)
    return 2 * tokens * (m["in_chans"] + 3) * C + 8 * C * C + blocks + 2 * tokens * C * 3


def read(ctx):
    windows = ctx.counts["real_windows"]
    if not windows or ctx.window_s <= 0 or ctx.run.device.type != "cuda":
        return None
    flops = (windows * ctx.counts["real_rows_per_window"] * ctx.traffic["sampling_timesteps"]
             * forward_flops(ctx.config["model"]))
    return 100.0 * flops / ctx.window_s / PEAK_FLOPS[ctx.dtype]

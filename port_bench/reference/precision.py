"""Matrix products of the reference, in its own precision or in a lower one.

The reference computes every product in the dtype of its operands (float64
for the yardstick). The controls that prove the comparison can fail compute
the same model with each product's operands rounded first:

  * `tf32`: to TF32 (10 explicit mantissa bits, round to nearest, ties away
    from zero, as cvt.rna does), the product accumulated in float32: what a
    float32 product on the tensor cores gives with TF32 on, the step below a
    float32 configuration;
  * `fp8`: to float8 e4m3 with one scale a tensor (its largest magnitude
    onto 448), accumulated in float32: the step below a bfloat16
    configuration.

Each is an autograd Function whose backward rounds its operands the same
way, so a control's training step runs its gradients in that precision too.
"""

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def round_tf32(x):
    """float32 x rounded to TF32, kept in float32."""
    bits = x.float().contiguous().view(torch.int32)
    # add half of the 13 dropped bits' unit to the magnitude, then drop them:
    # round to nearest, ties away from zero
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_fp8(x):
    """x rounded to float8 e4m3 under one per-tensor scale, in float32."""
    x = x.float()
    amax = x.abs().amax().clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


ROUNDERS = {"tf32": round_tf32, "fp8": round_fp8}


class _RoundedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, rnd):
        ctx.save_for_backward(a, b)
        ctx.rnd = rnd
        return torch.matmul(rnd(a), rnd(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        rnd = ctx.rnd
        ga = torch.matmul(rnd(g), rnd(b).transpose(-1, -2))
        gb = torch.matmul(rnd(a).transpose(-1, -2), rnd(g))
        # broadcast batch axes summed back to each operand's shape
        while ga.dim() > a.dim():
            ga = ga.sum(0)
        while gb.dim() > b.dim():
            gb = gb.sum(0)
        return ga, gb, None


def matmul_fn(mode=None):
    """The reference's product: plain `torch.matmul` (mode None), or the
    control's, each operand rounded to `mode` ("tf32" or "fp8") in float32."""
    if mode is None:
        return torch.matmul
    rnd = ROUNDERS[mode]
    return lambda a, b: _RoundedMatmul.apply(a.float(), b.float(), rnd)

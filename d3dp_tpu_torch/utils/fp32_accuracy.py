"""How far the fp32 kernels' products sit from float64, on the card.

The fp32 kernels run each contraction (the stage's o @ Wp, the MLP's fc1
and fc2) inside a fused walk, so their outputs carry what comes before and
after it. The tensor-parallel partial forms, called with the whole
contraction (one rank holding every head and every hidden unit), run the
same walks as the whole forms (`proj_ln2_walk_f32<true>`,
`mlp_walk_f32<false, true>`: the same k-loop, another epilogue) and write
the raw fp32 product. Given a weight of zeros and ones that picks one input
per output (a selector), tf32x3 adds lo(a) and hi(a) into an empty
accumulator, exactly: the output is hi(a) + lo(a), the very value the walk
multiplies. So each contraction is read on its own, the kernel's product
against its own operand, recovered so, times the same weights in float64;
beside it the same fp32 operands multiplied in fp32 on the same device
(with TF32 off, cuBLAS: the plain versions' product):

    readings = contraction_errors(qkv, wp, y, w1, b1, w2, num_heads, scale)

fc1 is read before its activation, under the `nogelu` MLP variant, so that
its reading is the product's alone (+ b1). Measurement code: the port's
paths never call it.
"""

import os
from unittest import mock

import torch

from d3dp_tpu_torch.ops import attention, mlp


def selector(K, N, first, device):
    """(K, N) fp32 with ones at (first + j, j), j < min(N, K - first)."""
    s = torch.zeros(K, N, dtype=torch.float32, device=device)
    j = torch.arange(min(N, K - first), device=device)
    s[first + j, j] = 1.0
    return s


def proj_operand(qkv, num_heads, scale):
    """The attention output o (R, N, C) that K6-tp's projection walk
    multiplies, as hi + lo, from the partial form on a selector."""
    C = qkv.shape[-1] // 3
    return attention.attention_block_partial(qkv, selector(C, C, 0, qkv.device), num_heads,
                                             scale)


def mlp_operand(y, w1, b1, variant=None):
    """The hidden activations (R, H) that the MLP walk's fc2 multiplies, as
    hi + lo, from the partial form on selectors of C hidden units at a time,
    under the MLP variant `variant` (None: production's GELU)."""
    C, H = w1.shape
    with mock.patch.dict(os.environ):  # restored on exit
        os.environ.pop("D3DP_MLP_VARIANT", None)
        if variant is not None:
            os.environ["D3DP_MLP_VARIANT"] = variant
        parts = [mlp.mlp_block_partial(y, w1, b1, selector(H, C, k, y.device))[:, :H - k]
                 for k in range(0, H, C)]
    return torch.cat(parts, dim=1)


def _reading(kernel, operand, weight, bias=None):
    """max |kernel - operand @ weight (+ bias)| with the product in float64,
    the same for the fp32 product, and max |float64 product|."""
    f64 = torch.float64
    a = operand.reshape(-1, operand.shape[-1])
    want = a.to(f64) @ weight.to(f64)
    plain = a @ weight
    if bias is not None:
        want, plain = want + bias.to(f64), plain + bias
    return dict(kernel=(kernel.reshape(want.shape).to(f64) - want).abs().max().item(),
                plain=(plain.to(f64) - want).abs().max().item(),
                out=want.abs().max().item(), K=a.shape[1])


def contraction_errors(qkv, wp, y, w1, b1, w2, num_heads, scale):
    """{"proj", "fc1", "fc2": {kernel, plain, out, K}} in the fp32 walks at
    the whole contraction: o @ Wp from packed qkv (R, N, 3C) and wp (C, C);
    fc1 (with + b1) and fc2 from rows y (M, C), w1 (C, H), b1 (H,), w2
    (H, C). fp32 CUDA operands."""
    out = {}
    o = proj_operand(qkv, num_heads, scale)
    out["proj"] = _reading(attention.attention_block_partial(qkv, wp, num_heads, scale), o, wp)
    del o
    out["fc1"] = _reading(mlp_operand(y, w1, b1, "nogelu"), y, w1, b1)
    h = mlp_operand(y, w1, b1)
    out["fc2"] = _reading(mlp.mlp_block_partial(y, w1, b1, w2), h, w2)
    return out

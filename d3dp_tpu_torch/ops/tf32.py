"""The TF32 hi and lo planes of fp32 weights, the weight operand of the fp32
kernels.

The fp32 kernels (the stage's ln_qkv and proj_ln2 walks, the MLP walk, and
the depth-resident kernel that inlines them: `csrc/mlp.cuh`, "fp32:
tf32x3") multiply on the tensor cores in TF32, three passes into an fp32
accumulator (the qkv, projection and fc2 products: a fresh one each 32-k
stage, added in fp32), the Hopper form of the JAX kernels' fp32 products at
`Precision.HIGHEST`. Each operand v splits into hi = tf32(v) and lo =
tf32(v - hi); the activations split inside the kernel, the weights here
into planes in nn.Linear's own (out, in) layout, which the tensor cores
read K-major.

`planes(w)` takes a weight in the JAX package's (in, out) layout, or a
stack of them, and returns (..., 2, out, in) fp32: hi at [..., 0], lo at
[..., 1]. Each fp32 op takes them as its `planes` argument and makes them
at the call where it is None; the model's weight cache (`MixSTE2._weights`)
makes them once per weight version and passes them.
"""

import torch

from d3dp_tpu_torch.ops import _build


def round_tf32(x):
    """fp32 x rounded to TF32 as `cvt.rna.tf32.f32` rounds it: to the
    nearest value with 10 mantissa bits, ties away from zero, the low 13
    bits of the result zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def planes(w):
    """(..., 2, N, K) fp32 of w (..., K, N): the transpose's hi = tf32(w)
    and lo = tf32(w - hi), so that hi + lo rebuilds w within 2^-22 of it."""
    wt = w.float().transpose(-1, -2)
    hi = round_tf32(wt)
    return torch.stack((hi, round_tf32(wt - hi)), dim=-3)


def operands(weights, names, device, given=None):
    """The fp32 kernels' weight operands for `weights` (named `names`): the
    planes in `given` (a sequence beside `weights`; None, or a None entry:
    made here for this call), each checked like any operand (device, dtype,
    shape, contiguity)."""
    given = (None,) * len(weights) if given is None else tuple(given)
    if len(given) != len(weights):
        raise ValueError(f"planes: {len(given)} given for {len(weights)} matrices {names}")
    out = []
    for w, name, p in zip(weights, names, given):
        p = planes(w) if p is None else p
        _build.check_operand(p, f"{name} planes", torch.float32,
                             (*w.shape[:-2], 2, w.shape[-1], w.shape[-2]), device)
        out.append(p)
    return tuple(out)

"""Plain torch helpers shared by the ops' reference versions."""

import torch


def layer_norm_rows(x32, scale, bias, eps):
    """LayerNorm over the last axis of an fp32 tensor: two-pass fp32
    statistics, then (x - mu) * rsqrt(var + eps) * scale + bias."""
    mu = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mu
    var = xc.square().mean(dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + eps) * scale.float() + bias.float()


def matmul_f32acc(a, b):
    """Product of compute-dtype operands with fp32 accumulation: the exact
    products of the rounded values, summed in fp32, as the kernels' MMAs do."""
    return torch.matmul(a.float(), b.float())


def matmul_f32out(a, b):
    """2-D product of compute-dtype operands with an fp32 result (the JAX
    backwards' `preferred_element_type=f32`): bf16 operands on the card stay
    bf16 tensor-core GEMMs accumulating in fp32 (`torch.mm`'s out_dtype);
    elsewhere the operands are upcast first, as `matmul_f32acc` does."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())

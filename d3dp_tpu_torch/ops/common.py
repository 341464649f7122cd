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

"""The analytic LayerNorm backward shared by the fused ops' backwards.

Counterpart of `_ln_bwd_rows` in the JAX package (`d3dp_tpu/ops/norm.py`),
this package's own copy.
"""

import torch


def ln_stats(s32, eps):
    """(normalised rows, rsqrt(var + eps)) of fp32 rows, two-pass
    statistics."""
    mu = s32.mean(dim=-1, keepdim=True)
    xc = s32 - mu
    rstd = torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    return xc * rstd, rstd


def ln_bwd_rows(s32, scale, g, eps):
    """Backward of y = LN(s) * scale + bias over the rows of s32 (M, C) fp32
    given dy = g (M, C): returns (ds fp32, dscale, dbias)."""
    shat, rstd = ln_stats(s32, eps)
    g32 = g.float()
    gs = g32 * scale.float()
    ds = rstd * (gs - gs.mean(dim=-1, keepdim=True)
                 - shat * (gs * shat).mean(dim=-1, keepdim=True))
    return ds, (g32 * shat).sum(dim=0), g32.sum(dim=0)

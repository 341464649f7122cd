"""The residual-LayerNorm epilogue of a tensor-parallel block half.

Under `--tp` a rank computes its share of a block half's row-parallel
product (the attention's out-projection, the MLP's fc2) with the partial
forms of the stage, block and MLP kernels (`ops.attention.
attention_stage_partial`, `attention_block_partial`, `ops.mlp.
mlp_block_partial`), which stop before their epilogue: the shares are
summed over the tp ranks (`parallel.tp.reduce_from_tp`) and this op
finishes the half:

    x2 = res + (part + bias);  y = LN(x2)

with the bias added once, after the sum, fp32 statistics, and x2 and y in
the compute dtype. The attention half needs both (x2 is the MLP's
residual); the MLP half needs only y, row for row (levels 1-2) or written
in the other stage's layout, (B, D1, D2, C) -> (B, D2, D1, C) (levels 3-4,
K2's relayout).

With `dp` (training under tp with `D3DP_TRAIN_FUSED=1`) the branch, its
bias included, is scaled per sequence before the residual add, as the
DropPath forms of the stage and MLP kernels scale theirs:

    x2 = res + dp * (part + bias)

dp (R,) over the attention half's rows of N tokens, (B, D1) over the MLP
half's (B, D1, D2, C) rows; generally, dp's shape is a leading part of
res's, one scale a group of the trailing rows. Under tp the two halves
then compute what the DropPath kernels K1-dp, K2-dp and K5-dp compute.
`residual_ln_ad` is the op with its backward (plain torch ops: the
LayerNorm's backward, then the residual's and the scaled branch's
gradients; dp gets none), for the tensor-parallel `D3DP_TRAIN_FUSED=1`
path.

The JAX package has no counterpart: under its tp mesh XLA inserts the
all-reduce and runs the un-split kernels on gathered operands. On a CUDA
tensor the op launches its hand-written kernel (`csrc/residual_ln.cu`); on
a CPU tensor it runs `residual_ln_plain`. There is no fallback between the
two.
"""

import ctypes

import torch

from d3dp_tpu_torch.ops import _build
from d3dp_tpu_torch.ops.common import layer_norm_rows
from d3dp_tpu_torch.ops.norm import ln_bwd_rows

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = [_P] * 6 + [_I] + [_P] * 2 + [_I] * 5 + [_F, _P]
_FN = {torch.bfloat16: "d3dp_residual_ln_bf16", torch.float32: "d3dp_residual_ln_f32"}


def _dp_view(dp, res):
    """dp (a leading part of res's shape) viewed to broadcast over res."""
    if tuple(dp.shape) != tuple(res.shape[:dp.dim()]):
        raise ValueError(f"dp {tuple(dp.shape)} is not a leading part of res "
                         f"{tuple(res.shape)}")
    return dp.float().reshape(*dp.shape, *(1,) * (res.dim() - dp.dim()))


def residual_ln_plain(res, part, bias, ln_s, ln_b, eps, with_x2=True, transpose=False,
                      dp=None):
    """Plain torch ops in the kernel's order: v = res + [dp *] (part +
    bias) in fp32, LN(v) with two-pass fp32 statistics; x2 = v and y
    rounded to res's dtype. res (..., C) in the compute dtype, part (..., C)
    fp32; with transpose res is (B, D1, D2, C) and y comes out (B, D2, D1,
    C); dp fp32 of a leading part of res's shape (module docstring).
    Returns (x2, y), or y alone without with_x2."""
    dt = res.dtype
    branch = part + bias.float()
    if dp is not None:
        branch = branch * _dp_view(dp, res)
    v = res.float() + branch
    y = layer_norm_rows(v, ln_s, ln_b, eps).to(dt)
    if transpose:
        y = y.transpose(1, 2).contiguous()
    return (v.to(dt), y) if with_x2 else y


def residual_ln(res, part, bias, ln_s, ln_b, eps, with_x2=True, transpose=False, dp=None):
    """(x2, y) or y of the epilogue; see the module docstring and
    `residual_ln_plain` for the operands."""
    if res.device.type == "cpu":
        return residual_ln_plain(res, part, bias, ln_s, ln_b, eps, with_x2, transpose, dp)
    if res.device.type != "cuda":
        raise ValueError(f"residual_ln: unsupported device {res.device}")
    dt = res.dtype
    if dt not in _FN:
        raise ValueError(f"residual_ln: unsupported dtype {dt}")
    C = res.shape[-1]
    if C % 32 or not 32 <= C <= 1024:
        raise ValueError(f"residual_ln: needs C % 32 == 0 and 32 <= C <= 1024 (C={C})")
    if transpose:
        if res.dim() != 4:
            raise ValueError(f"res must be (B, D1, D2, C) to transpose, got {tuple(res.shape)}")
        B, D1, D2, _ = res.shape
        y_shape = (B, D2, D1, C)
    else:
        B, D1, D2 = 1, res.numel() // C, 1
        y_shape = res.shape
    dev = res.device
    f32 = torch.float32
    for t, name, dtype, shape in ((res, "res", dt, res.shape), (part, "part", f32, res.shape),
                                  (bias, "bias", f32, (C,)), (ln_s, "ln_s", f32, (C,)),
                                  (ln_b, "ln_b", f32, (C,))):
        _build.check_operand(t, name, dtype, shape, dev)
    dp_div = 1
    if dp is not None:
        _dp_view(dp, res)
        _build.check_operand(dp, "dp", f32, dp.shape, dev)
        dp_div = res.numel() // C // dp.numel()
    x2 = torch.empty_like(res) if with_x2 else None
    y = torch.empty(y_shape, dtype=dt, device=dev)
    lib = _build.load("residual_ln", {fn: _SIG for fn in _FN.values()})
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _FN[dt])(
            res.data_ptr(), part.data_ptr(), bias.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
            None if dp is None else dp.data_ptr(), dp_div,
            None if x2 is None else x2.data_ptr(), y.data_ptr(), B, D1, D2, C, int(transpose),
            float(eps), stream)
    _build.check(err, "residual_ln")
    residual_ln.launches += 1
    if dp is not None:
        residual_ln.dp_launches += 1
    return (x2, y) if with_x2 else y


# every launch, and those of the DropPath form among them
residual_ln.launches = 0
residual_ln.dp_launches = 0


class _ResidualLN(torch.autograd.Function):
    """Forward: `residual_ln`; backward: the LayerNorm's backward on x2 (the
    attention half, whose LN2 the JAX stage VJP differentiates at the
    rounded x2) or on v recomputed in fp32 (the MLP half, as the JAX MLP
    VJP recomputes it), then d(res) = ds and d(part) = [dp *] ds, d(bias)
    its sum over rows."""

    @staticmethod
    def forward(ctx, res, part, bias, ln_s, ln_b, dp, eps, with_x2, transpose):
        out = residual_ln(res, part, bias, ln_s, ln_b, eps, with_x2, transpose, dp)
        x2 = out[0] if with_x2 else None
        ctx.save_for_backward(res, part, bias, ln_s, dp, x2)
        ctx.cfg = (eps, with_x2, transpose)
        return out

    @staticmethod
    def backward(ctx, *grads):
        res, part, bias, ln_s, dp, x2 = ctx.saved_tensors
        eps, with_x2, transpose = ctx.cfg
        gx2, gy = grads if with_x2 else (None, grads[0])
        C = res.shape[-1]
        if transpose:
            gy = gy.transpose(1, 2)
        if x2 is None:
            branch = part + bias.float()
            if dp is not None:
                branch = branch * _dp_view(dp, res)
            v = res.float() + branch
        else:
            v = x2.float()
        ds, dln_s, dln_b = ln_bwd_rows(v.reshape(-1, C), ln_s, gy.reshape(-1, C), eps)
        ds = ds.view(res.shape)
        if gx2 is not None:
            ds = ds + gx2.float()
        dpart = ds if dp is None else ds * _dp_view(dp, res)
        dbias = dpart.reshape(-1, C).sum(dim=0).to(bias.dtype)
        return (ds.to(res.dtype), dpart, dbias, dln_s.to(ln_s.dtype), dln_b.to(ln_s.dtype),
                None, None, None, None)


def residual_ln_ad(res, part, bias, ln_s, ln_b, eps, with_x2=True, transpose=False, dp=None):
    """Differentiable `residual_ln` (module docstring); dp gets no
    gradient."""
    return _ResidualLN.apply(res, part, bias, ln_s, ln_b, dp, eps, with_x2, transpose)

"""The fused MLP half of a MixSTE block, in two layouts.

`mlp_block_t` is the counterpart of `mlp_block_t_p` in the JAX package
(`d3dp_tpu/ops/mlp.py`): y = LN(res + fc2(GELU_erf(fc1(x)))) on
(B, D1, D2, C) inputs, written as (B, D2, D1, C) -- the spatial<->temporal
relayout of MixSTE rides the output write (fuse levels 3 and 4).

`mlp_block` is the counterpart of `mlp_block_p`: the same function on
(R, C) token rows, written row for row (fuse levels 1 and 2).

`mlp_block_partial` is the tensor-parallel partial form of both (K2/K5-tp):
on a rank holding H / tp of the hidden units (its columns of fc1 and rows
of fc2, `parallel.mesh.shard_params`) it returns the raw fp32 fc2 product
of (R, C) rows, with no fc2 bias, residual, LayerNorm or transpose; the
ranks' products are summed and `ops.residual_ln` finishes the half, in
either layout (with a DropPath scale under training: K2-dp's and K5-dp's
tp form). `mlp_block_partial_ad` is it with its backward, for
`D3DP_TRAIN_FUSED=1` under tp.

`mlp_block_t_dp` and `mlp_block_dp` are `mlp_block_t_dp_p` and
`mlp_block_dp_p`: the branch, fc2's bias included, scaled by a DropPath
scale in fp32 before the residual add, one per (b, i) of (B, D1) or one
per row (training at level 4).

The lab switch `D3DP_MLP_VARIANT` is read when an op is called and picks
the activation as the JAX kernels' `_gelu_inkernel` does (`gelu_mode`):
"nogelu" the identity (both dtypes), "bf16gelu" in bf16 the erf polynomial
evaluated op by op in bf16 (`gelu_bf16`), any other value, and bf16gelu in
fp32, the exact GELU. The kernels take it as an int (`GELU_*`, kGelu* in
`csrc/mlp.cuh`), the plain versions as their `gelu` argument.

Training with `D3DP_TRAIN_FUSED=1` differentiates them through
`torch.autograd.Function`s (`mlp_block_ad`, `mlp_block_dp_ad`,
`mlp_block_t_ad`, `mlp_block_t_dp_ad`) whose backward is the JAX package's
`_mlp_bwd_impl` in plain torch ops: the hidden activation recomputed, the
matrix products on compute-dtype operands with fp32 accumulation, the GELU
derivative in fp32 with the exact erf -- the exact GELU's whatever
`D3DP_MLP_VARIANT` the forward ran, as in JAX. The DropPath scale gets no
gradient.

In fp32 the kernels multiply in three TF32 passes from w1's and w2's hi and
lo planes (`ops.tf32`): those passed as `planes` (the model's weight cache
makes them once per weight version), else made at the call.

On a CUDA tensor each launches its hand-written kernel (both forms of one
kernel in `csrc/mlp_block_t.cu`); on a CPU tensor it runs its `*_plain`
version. There is no fallback between the two.
"""

import ctypes
import math
import os

import torch
import torch.nn.functional as F

from d3dp_tpu_torch.ops import _build, tf32
from d3dp_tpu_torch.ops.common import layer_norm_rows, matmul_f32acc as _mm, matmul_f32out
from d3dp_tpu_torch.ops.norm import ln_bwd_rows

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG_T = [_P] * 9 + [_I] * 6 + [_F, _P]
_SIG_ROWS = [_P] * 9 + [_I] * 4 + [_F, _P]
_SIG_T_DP = [_P] * 10 + [_I] * 6 + [_F, _P]
_SIG_ROWS_DP = [_P] * 10 + [_I] * 4 + [_F, _P]
_FN_T = {torch.bfloat16: "d3dp_mlp_block_t_bf16", torch.float32: "d3dp_mlp_block_t_f32"}
_FN_ROWS = {torch.bfloat16: "d3dp_mlp_block_bf16", torch.float32: "d3dp_mlp_block_f32"}
_FN_T_DP = {torch.bfloat16: "d3dp_mlp_block_t_dp_bf16",
            torch.float32: "d3dp_mlp_block_t_dp_f32"}
_FN_ROWS_DP = {torch.bfloat16: "d3dp_mlp_block_dp_bf16", torch.float32: "d3dp_mlp_block_dp_f32"}
_SIG_PART = [_P] * 5 + [_I] * 4 + [_P]
_FN_PART = {torch.bfloat16: "d3dp_mlp_block_partial_bf16",
            torch.float32: "d3dp_mlp_block_partial_f32"}


# the activations of D3DP_MLP_VARIANT (kGelu* in csrc/mlp.cuh)
GELU_ERF, GELU_BF16, GELU_NONE = 0, 1, 2


def gelu_mode(dtype):
    """The activation `D3DP_MLP_VARIANT` selects for the compute dtype, as
    the JAX kernels' `_gelu_inkernel`: nogelu -> GELU_NONE, bf16gelu in
    bf16 -> GELU_BF16, anything else -> GELU_ERF."""
    v = os.environ.get("D3DP_MLP_VARIANT", "")
    if v == "nogelu":
        return GELU_NONE
    if v == "bf16gelu" and dtype == torch.bfloat16:
        return GELU_BF16
    return GELU_ERF


def gelu_bf16(h32):
    """The JAX kernels' bf16gelu (`_gelu_inkernel`, `_erf_poly_from_abs`):
    |z| and sign(z) of z = h / sqrt 2 from fp32, then the A&S 7.1.26 erf
    polynomial and 0.5 * bf16(h) * (1 + erf), every constant and every
    operation rounded to bf16 (JAX's weak-typed constants take the bf16
    operand's type); fp32 out."""
    bf = torch.bfloat16

    def c(v):
        return torch.tensor(v, dtype=bf, device=h32.device)

    z = h32 * 2.0 ** -0.5
    a, sgn = z.abs().to(bf), torch.sign(z).to(bf)
    t = c(1.0) / (c(1.0) + c(0.3275911) * a)
    poly = t * (c(0.254829592) + t * (c(-0.284496736) + t * (
        c(1.421413741) + t * (c(-1.453152027) + t * c(1.061405429)))))
    erf = sgn * (c(1.0) - poly * torch.exp(-a * a))
    return (c(0.5) * h32.to(bf) * (c(1.0) + erf)).float()


def _activation(h32, gelu):
    if gelu == GELU_NONE:
        return h32
    if gelu == GELU_BF16:
        return gelu_bf16(h32)
    return F.gelu(h32, approximate="none")


def _mlp_ln(x, res, w1, b1, w2, b2, ln_s, ln_b, eps, dp=None, gelu=GELU_ERF):
    """The TPU kernels' order: h = act(x W1 + b1) in fp32, rounded to the
    compute dtype; s = res + [dp *] (h W2 + b2); LN(s) in fp32. dp
    broadcasts against the leading axes of x; gelu: a GELU_* activation."""
    h = _activation(_mm(x, w1) + b1.float(), gelu)
    branch = _mm(h.to(x.dtype), w2) + b2.float()
    if dp is not None:
        branch = branch * dp.float().reshape(*dp.shape, *(1,) * (x.dim() - dp.dim()))
    return layer_norm_rows(res.float() + branch, ln_s, ln_b, eps)


def mlp_block_t_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps, dp=None, gelu=GELU_ERF):
    """Plain torch ops in the TPU kernel's order, rounded to the compute
    dtype and transposed (B, D1, D2, C) -> (B, D2, D1, C); dp (B, D1)."""
    y = _mlp_ln(x, res, w1, b1, w2, b2, ln_s, ln_b, eps, dp, gelu)
    return y.to(x.dtype).transpose(1, 2).contiguous()


def mlp_block_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps, dp=None, gelu=GELU_ERF):
    """Plain torch ops in the TPU kernel's order on (R, C) rows; dp (R,)."""
    return _mlp_ln(x, res, w1, b1, w2, b2, ln_s, ln_b, eps, dp, gelu).to(x.dtype)


def mlp_block_t_dp_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, dp, eps, gelu=GELU_ERF):
    return mlp_block_t_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps, dp, gelu)


def mlp_block_dp_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, dp, eps, gelu=GELU_ERF):
    return mlp_block_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps, dp, gelu)


def check_shape(what, C, H, dtype):
    """Raise unless the kernels take C channels and H hidden units in dtype:
    the wgmma walks (128-column output blocks, C / 2 a warpgroup, and
    128-column hidden chunks) take C % 128 == 0, C <= 512, H % 128 == 0 in
    bf16 and fp32."""
    if C % 128 or C > 512 or H % 128 or H < 128:
        raise ValueError(f"{what}: needs C % 128 == 0, C <= 512 and H % 128 == 0 in {dtype} "
                         f"(C={C}, H={H})")


def _launch(what, fns, sigs, x, res, w1, b1, w2, b2, ln_s, ln_b, eps, out_shape, dims, gelu,
            dp=None, dp_shape=None, planes=None):
    """Check the operands of either form and launch its kernel; `dims` are
    the integer shape arguments the C entry point takes before C and H;
    gelu: a GELU_* activation; dp: the DropPath form's scales, of dp_shape.
    fp32 runs on (w1, w2)'s TF32 planes: `planes`, else made here
    (`ops.tf32.operands`)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    C = x.shape[-1]
    H = w1.shape[-1]
    dt = x.dtype
    if dt not in fns:
        raise ValueError(f"{what}: unsupported dtype {dt}")
    check_shape(what, C, H, dt)
    dev = x.device
    f32 = torch.float32
    for t, name, dtype, shape in (
            (x, "x", dt, x.shape), (res, "res", dt, x.shape),
            (w1, "w1", dt, (C, H)), (b1, "b1", f32, (H,)),
            (w2, "w2", dt, (H, C)), (b2, "b2", f32, (C,)),
            (ln_s, "ln_s", f32, (C,)), (ln_b, "ln_b", f32, (C,))) + (
                ((dp, "dp", f32, dp_shape),) if dp is not None else ()):
        _build.check_operand(t, name, dtype, shape, dev)
    if dt == f32:
        w1, w2 = tf32.operands((w1, w2), ("w1", "w2"), dev, planes)
    out = torch.empty(out_shape, dtype=dt, device=dev)
    lib = _build.load("mlp_block_t", {fn: sig for fns_, sig in sigs for fn in fns_.values()})
    ptrs = [t.data_ptr() for t in (x, res, w1, b1, w2, b2, ln_s, ln_b)]
    if dp is not None:
        ptrs.append(dp.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fns[dt])(*ptrs, out.data_ptr(), *dims, C, H, gelu, float(eps),
                                    stream)
    _build.check(err, what)
    return out


# every entry point of the library, for its one load
_SIGS = ((_FN_T, _SIG_T), (_FN_ROWS, _SIG_ROWS), (_FN_T_DP, _SIG_T_DP),
         (_FN_ROWS_DP, _SIG_ROWS_DP), (_FN_PART, _SIG_PART))


def mlp_block_t(x, res, w1, b1, w2, b2, ln_s, ln_b, eps, planes=None):
    """LN(res + MLP(x)) written transposed; see the module docstring.
    planes: fp32's (w1, w2) TF32 planes, or None."""
    gelu = gelu_mode(x.dtype)
    if x.device.type == "cpu":
        return mlp_block_t_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps, gelu=gelu)
    if x.dim() != 4:
        raise ValueError(f"x must be (B, D1, D2, C), got {tuple(x.shape)}")
    B, D1, D2, C = x.shape
    out = _launch("mlp_block_t", _FN_T, _SIGS, x, res, w1, b1, w2, b2, ln_s, ln_b, eps,
                  (B, D2, D1, C), (B, D1, D2), gelu, planes=planes)
    mlp_block_t.launches += 1
    return out


def mlp_block_t_dp(x, res, w1, b1, w2, b2, ln_s, ln_b, dp, eps, planes=None):
    """`mlp_block_t` with the branch scaled by dp (B, D1) fp32."""
    gelu = gelu_mode(x.dtype)
    if x.device.type == "cpu":
        return mlp_block_t_dp_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, dp, eps, gelu=gelu)
    if x.dim() != 4:
        raise ValueError(f"x must be (B, D1, D2, C), got {tuple(x.shape)}")
    B, D1, D2, C = x.shape
    out = _launch("mlp_block_t_dp", _FN_T_DP, _SIGS, x, res, w1, b1, w2, b2, ln_s, ln_b, eps,
                  (B, D2, D1, C), (B, D1, D2), gelu, dp, (B, D1), planes)
    mlp_block_t_dp.launches += 1
    return out


def mlp_block(x, res, w1, b1, w2, b2, ln_s, ln_b, eps, planes=None):
    """LN(res + MLP(x)) on (R, C) rows; see the module docstring. planes:
    fp32's (w1, w2) TF32 planes, or None."""
    gelu = gelu_mode(x.dtype)
    if x.device.type == "cpu":
        return mlp_block_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps, gelu=gelu)
    if x.dim() != 2:
        raise ValueError(f"x must be (R, C), got {tuple(x.shape)}")
    out = _launch("mlp_block", _FN_ROWS, _SIGS, x, res, w1, b1, w2, b2, ln_s, ln_b, eps,
                  x.shape, (x.shape[0],), gelu, planes=planes)
    mlp_block.launches += 1
    return out


def mlp_block_dp(x, res, w1, b1, w2, b2, ln_s, ln_b, dp, eps, planes=None):
    """`mlp_block` with the branch scaled by dp (R,) fp32."""
    gelu = gelu_mode(x.dtype)
    if x.device.type == "cpu":
        return mlp_block_dp_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, dp, eps, gelu=gelu)
    if x.dim() != 2:
        raise ValueError(f"x must be (R, C), got {tuple(x.shape)}")
    out = _launch("mlp_block_dp", _FN_ROWS_DP, _SIGS, x, res, w1, b1, w2, b2, ln_s, ln_b, eps,
                  x.shape, (x.shape[0],), gelu, dp, (x.shape[0],), planes)
    mlp_block_dp.launches += 1
    return out


mlp_block_t.launches = 0
mlp_block_t_dp.launches = 0
mlp_block.launches = 0
mlp_block_dp.launches = 0


def mlp_block_partial_plain(x, w1, b1, w2, gelu=GELU_ERF):
    """Plain torch ops of K2/K5-tp in the TPU kernels' order: h = act(x W1
    + b1) in fp32, rounded to the compute dtype, then h W2 -> fp32; x (R,
    C), w1 (C, H), b1 (H,), w2 (H, C) with H a rank's share."""
    h = _activation(_mm(x, w1) + b1.float(), gelu)
    return _mm(h.to(x.dtype), w2)


def mlp_block_partial(x, w1, b1, w2):
    """K2/K5-tp: a tensor-parallel rank's share of the MLP half on (R, C)
    rows, its fp32 (R, C) fc2 product; see the module docstring. fp32 makes
    (w1, w2)'s TF32 planes here: the rank's weights change every step."""
    gelu = gelu_mode(x.dtype)
    if x.device.type == "cpu":
        return mlp_block_partial_plain(x, w1, b1, w2, gelu)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_block_partial: unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"x must be (R, C), got {tuple(x.shape)}")
    R, C = x.shape
    H = w1.shape[-1]
    dt, dev, f32 = x.dtype, x.device, torch.float32
    if dt not in _FN_PART:
        raise ValueError(f"mlp_block_partial: unsupported dtype {dt}")
    check_shape("mlp_block_partial", C, H, dt)
    for t, name, dtype, shape in ((x, "x", dt, (R, C)), (w1, "w1", dt, (C, H)),
                                  (b1, "b1", f32, (H,)), (w2, "w2", dt, (H, C))):
        _build.check_operand(t, name, dtype, shape, dev)
    if dt == f32:
        w1, w2 = tf32.operands((w1, w2), ("w1", "w2"), dev)
    part = torch.empty((R, C), dtype=f32, device=dev)
    lib = _build.load("mlp_block_t", {fn: sig for fns_, sig in _SIGS for fn in fns_.values()})
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _FN_PART[dt])(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                                         w2.data_ptr(), part.data_ptr(), R, C, H, gelu, stream)
    _build.check(err, "mlp_block_partial")
    mlp_block_partial.launches += 1
    return part


mlp_block_partial.launches = 0


# ------------------------------------------------------------ training
def _hidden(x, w1, b1):
    """(fc1's fp32 pre-activation, the exact GELU of it in x's dtype)."""
    pre = matmul_f32out(x, w1) + b1.float()
    return pre, F.gelu(pre, approximate="none").to(x.dtype)


def _mlp_branch_bwd(x, w1, b1, w2, ds_b, hidden=None):
    """The MLP branch's backward given the fp32 gradient ds_b (R, C) of its
    fc2 product (h W2, before bias, DropPath and residual): the hidden
    activation recomputed (or `hidden`, `_hidden`'s pair), products on
    compute-dtype operands with fp32 accumulation, the exact GELU's
    derivative in fp32. H hidden units of w1 (C, H): the whole MLP's, or a
    tensor-parallel rank's. Returns (dx, dw1, db1, dw2) in their operands'
    dtypes."""
    md = x.dtype
    pre, hb = hidden if hidden is not None else _hidden(x, w1, b1)
    ds_m = ds_b.to(md)
    dw2 = matmul_f32out(hb.t(), ds_m).to(w2.dtype)
    dh = matmul_f32out(ds_m, w2.t())
    # d gelu(p) = 0.5 * (1 + erf(p / sqrt2)) + p * pdf(p)
    dpre = dh * (0.5 * (1.0 + torch.erf(pre * 2.0 ** -0.5))
                 + pre * torch.exp(-0.5 * pre * pre) * (2.0 * math.pi) ** -0.5)
    dpre_m = dpre.to(md)
    dw1 = matmul_f32out(x.t(), dpre_m).to(w1.dtype)
    db1 = dpre.sum(dim=0).to(b1.dtype)
    dx = matmul_f32out(dpre_m, w1.t()).to(x.dtype)
    return dx, dw1, db1, dw2


def mlp_bwd_rows(x, res, w1, b1, w2, b2, ln_s, gy, eps, dp=None):
    """Gradients of the rows form given dy = gy (R, C): the JAX package's
    `_mlp_bwd_impl` in plain torch ops, the LayerNorm's backward on the
    recomputed fp32 sum, then `_mlp_branch_bwd`. dp (R, 1) or None. Returns
    (dx, dres, dw1, db1, dw2, db2, dln_s, dln_b); weight and bias gradients
    in their parameters' dtypes, as the JAX VJP returns them."""
    pre, hb = _hidden(x, w1, b1)
    branch32 = matmul_f32out(hb, w2) + b2.float()
    if dp is not None:
        dp32 = dp.float()
        branch32 = branch32 * dp32
    s32 = res.float() + branch32

    ds, dln_s, dln_b = ln_bwd_rows(s32, ln_s, gy, eps)
    dres = ds.to(res.dtype)
    ds_b = ds if dp is None else ds * dp32
    db2 = ds_b.sum(dim=0).to(b2.dtype)
    dx, dw1, db1, dw2 = _mlp_branch_bwd(x, w1, b1, w2, ds_b, (pre, hb))
    return dx, dres, dw1, db1, dw2, db2, dln_s.to(ln_s.dtype), dln_b.to(ln_s.dtype)


class _MlpBlock(torch.autograd.Function):
    """Forward: one of the four MLP ops (rows or transposed, with or without
    DropPath); backward: `mlp_bwd_rows`, the transposed form's output
    gradient and scales brought back to its input rows first (the JAX
    `_mlp_block_t_p_bwd` / `_mlp_block_t_dp_p_bwd`)."""

    @staticmethod
    def forward(ctx, x, res, w1, b1, w2, b2, ln_s, ln_b, dp, eps, transpose):
        if transpose:
            op = mlp_block_t if dp is None else mlp_block_t_dp
        else:
            op = mlp_block if dp is None else mlp_block_dp
        args = (x, res, w1, b1, w2, b2, ln_s, ln_b) + (() if dp is None else (dp,))
        out = op(*args, eps)
        ctx.save_for_backward(x, res, w1, b1, w2, b2, ln_s, dp)
        ctx.cfg = (eps, transpose)
        return out

    @staticmethod
    def backward(ctx, gy):
        x, res, w1, b1, w2, b2, ln_s, dp = ctx.saved_tensors
        eps, transpose = ctx.cfg
        C = x.shape[-1]
        if transpose:
            B, D1, D2, _ = x.shape
            gy = gy.transpose(1, 2)
            if dp is not None:
                dp = dp[:, :, None].expand(B, D1, D2)
        grads = mlp_bwd_rows(x.reshape(-1, C), res.reshape(-1, C), w1, b1, w2, b2, ln_s,
                             gy.reshape(-1, C), eps,
                             None if dp is None else dp.reshape(-1, 1))
        return (grads[0].reshape(x.shape), grads[1].reshape(res.shape), *grads[2:],
                None, None, None)


def mlp_block_ad(x, res, w1, b1, w2, b2, ln_s, ln_b, eps):
    """Differentiable `mlp_block` (the JAX `mlp_block_p`)."""
    return _MlpBlock.apply(x, res, w1, b1, w2, b2, ln_s, ln_b, None, eps, False)


def mlp_block_dp_ad(x, res, w1, b1, w2, b2, ln_s, ln_b, dp, eps):
    """Differentiable `mlp_block_dp` (the JAX `mlp_block_dp_p`)."""
    return _MlpBlock.apply(x, res, w1, b1, w2, b2, ln_s, ln_b, dp, eps, False)


def mlp_block_t_ad(x, res, w1, b1, w2, b2, ln_s, ln_b, eps):
    """Differentiable `mlp_block_t` (the JAX `mlp_block_t_p`)."""
    return _MlpBlock.apply(x, res, w1, b1, w2, b2, ln_s, ln_b, None, eps, True)


def mlp_block_t_dp_ad(x, res, w1, b1, w2, b2, ln_s, ln_b, dp, eps):
    """Differentiable `mlp_block_t_dp` (the JAX `mlp_block_t_dp_p`)."""
    return _MlpBlock.apply(x, res, w1, b1, w2, b2, ln_s, ln_b, dp, eps, True)


class _MlpBlockPartial(torch.autograd.Function):
    """Forward: `mlp_block_partial` (K2/K5-tp); backward: `_mlp_branch_bwd`
    on the rank's hidden units given the gradient of the fp32 partial. x
    gets the rank's share of its gradient: the caller passes it through
    `parallel.tp.copy_to_tp`."""

    @staticmethod
    def forward(ctx, x, w1, b1, w2):
        ctx.save_for_backward(x, w1, b1, w2)
        return mlp_block_partial(x, w1, b1, w2)

    @staticmethod
    def backward(ctx, gpart):
        x, w1, b1, w2 = ctx.saved_tensors
        return _mlp_branch_bwd(x, w1, b1, w2, gpart.float())


def mlp_block_partial_ad(x, w1, b1, w2):
    """Differentiable `mlp_block_partial` (K2/K5-tp) on (R, C) rows."""
    return _MlpBlockPartial.apply(x, w1, b1, w2)

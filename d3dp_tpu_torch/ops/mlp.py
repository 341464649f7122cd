"""The fused MLP half of a MixSTE block, in two layouts.

`mlp_block_t` is the counterpart of `mlp_block_t_p` in the JAX package
(`d3dp_tpu/ops/mlp.py`): y = LN(res + fc2(GELU_erf(fc1(x)))) on
(B, D1, D2, C) inputs, written as (B, D2, D1, C) -- the spatial<->temporal
relayout of MixSTE rides the output write (fuse levels 3 and 4).

`mlp_block` is the counterpart of `mlp_block_p`: the same function on
(R, C) token rows, written row for row (fuse levels 1 and 2).

On a CUDA tensor each launches its hand-written kernel (both forms of one
kernel in `csrc/mlp_block_t.cu`); on a CPU tensor it runs its `*_plain`
version. There is no fallback between the two.
"""

import ctypes

import torch
import torch.nn.functional as F

from d3dp_tpu_torch.ops import _build
from d3dp_tpu_torch.ops.common import layer_norm_rows, matmul_f32acc as _mm

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG_T = [_P] * 9 + [_I, _I, _I, _I, _I, _F, _P]
_SIG_ROWS = [_P] * 9 + [_I, _I, _I, _F, _P]
_FN_T = {torch.bfloat16: "d3dp_mlp_block_t_bf16", torch.float32: "d3dp_mlp_block_t_f32"}
_FN_ROWS = {torch.bfloat16: "d3dp_mlp_block_bf16", torch.float32: "d3dp_mlp_block_f32"}


def _mlp_ln(x, res, w1, b1, w2, b2, ln_s, ln_b, eps):
    """The TPU kernels' order: h = GELU(x W1 + b1) in fp32, rounded to the
    compute dtype; s = res + (h W2 + b2); LN(s) in fp32."""
    h = F.gelu(_mm(x, w1) + b1.float(), approximate="none")
    branch = _mm(h.to(x.dtype), w2) + b2.float()
    return layer_norm_rows(res.float() + branch, ln_s, ln_b, eps)


def mlp_block_t_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps):
    """Plain torch ops in the TPU kernel's order, rounded to the compute
    dtype and transposed (B, D1, D2, C) -> (B, D2, D1, C)."""
    y = _mlp_ln(x, res, w1, b1, w2, b2, ln_s, ln_b, eps)
    return y.to(x.dtype).transpose(1, 2).contiguous()


def mlp_block_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps):
    """Plain torch ops in the TPU kernel's order on (R, C) rows."""
    return _mlp_ln(x, res, w1, b1, w2, b2, ln_s, ln_b, eps).to(x.dtype)


def _launch(what, fns, x, res, w1, b1, w2, b2, ln_s, ln_b, eps, out_shape, dims):
    """Check the operands of either form and launch its kernel; `dims` are
    the integer shape arguments the C entry point takes before C and H."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    C = x.shape[-1]
    H = w1.shape[-1]
    dt = x.dtype
    if dt not in fns:
        raise ValueError(f"{what}: unsupported dtype {dt}")
    if C % 64 or C > 1024 or H % 64:
        raise ValueError(f"{what}: needs C % 64 == 0, C <= 1024 and "
                         f"H % 64 == 0 (C={C}, H={H})")
    dev = x.device
    f32 = torch.float32
    for t, name, dtype, shape in (
            (x, "x", dt, x.shape), (res, "res", dt, x.shape),
            (w1, "w1", dt, (C, H)), (b1, "b1", f32, (H,)),
            (w2, "w2", dt, (H, C)), (b2, "b2", f32, (C,)),
            (ln_s, "ln_s", f32, (C,)), (ln_b, "ln_b", f32, (C,))):
        _build.check_operand(t, name, dtype, shape, dev)
    out = torch.empty(out_shape, dtype=dt, device=dev)
    lib = _build.load("mlp_block_t", {**{fn: _SIG_T for fn in _FN_T.values()},
                                      **{fn: _SIG_ROWS for fn in _FN_ROWS.values()}})
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fns[dt])(
            x.data_ptr(), res.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
            out.data_ptr(), *dims, C, H, float(eps), stream)
    _build.check(err, what)
    return out


def mlp_block_t(x, res, w1, b1, w2, b2, ln_s, ln_b, eps):
    """LN(res + MLP(x)) written transposed; see the module docstring."""
    if x.device.type == "cpu":
        return mlp_block_t_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps)
    if x.dim() != 4:
        raise ValueError(f"x must be (B, D1, D2, C), got {tuple(x.shape)}")
    B, D1, D2, C = x.shape
    out = _launch("mlp_block_t", _FN_T, x, res, w1, b1, w2, b2, ln_s, ln_b, eps,
                  (B, D2, D1, C), (B, D1, D2))
    mlp_block_t.launches += 1
    return out


def mlp_block(x, res, w1, b1, w2, b2, ln_s, ln_b, eps):
    """LN(res + MLP(x)) on (R, C) rows; see the module docstring."""
    if x.device.type == "cpu":
        return mlp_block_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps)
    if x.dim() != 2:
        raise ValueError(f"x must be (R, C), got {tuple(x.shape)}")
    out = _launch("mlp_block", _FN_ROWS, x, res, w1, b1, w2, b2, ln_s, ln_b, eps,
                  x.shape, (x.shape[0],))
    mlp_block.launches += 1
    return out


mlp_block_t.launches = 0
mlp_block.launches = 0

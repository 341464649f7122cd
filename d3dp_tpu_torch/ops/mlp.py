"""The fused, transposing MLP half of a MixSTE block.

`mlp_block_t` is the counterpart of `mlp_block_t_p` in the JAX package
(`d3dp_tpu/ops/mlp.py`): y = LN(res + fc2(GELU_erf(fc1(x)))) on
(B, D1, D2, C) inputs, written as (B, D2, D1, C) -- the spatial<->temporal
relayout of MixSTE rides the output write.

On a CUDA tensor it launches the hand-written kernel in
`csrc/mlp_block_t.cu`; on a CPU tensor it runs `mlp_block_t_plain`. There is
no fallback between the two.
"""

import ctypes

import torch
import torch.nn.functional as F

from d3dp_tpu_torch.ops import _build
from d3dp_tpu_torch.ops.common import layer_norm_rows, matmul_f32acc as _mm

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = [_P] * 9 + [_I, _I, _I, _I, _I, _F, _P]
_FN = {torch.bfloat16: "d3dp_mlp_block_t_bf16",
       torch.float32: "d3dp_mlp_block_t_f32"}


def mlp_block_t_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps):
    """Plain torch ops in the TPU kernel's order: h = GELU(x W1 + b1) in
    fp32, rounded to the compute dtype; s = res + (h W2 + b2); y = LN(s),
    rounded to the compute dtype and transposed (B, D1, D2, C) ->
    (B, D2, D1, C)."""
    dt = x.dtype
    h = F.gelu(_mm(x, w1) + b1.float(), approximate="none")
    branch = _mm(h.to(dt), w2) + b2.float()
    y = layer_norm_rows(res.float() + branch, ln_s, ln_b, eps)
    return y.to(dt).transpose(1, 2).contiguous()


def mlp_block_t(x, res, w1, b1, w2, b2, ln_s, ln_b, eps):
    """LN(res + MLP(x)) written transposed; see the module docstring."""
    if x.device.type == "cpu":
        return mlp_block_t_plain(x, res, w1, b1, w2, b2, ln_s, ln_b, eps)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_block_t: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, D1, D2, C), got {tuple(x.shape)}")
    B, D1, D2, C = x.shape
    H = w1.shape[-1]
    dt = x.dtype
    if dt not in _FN:
        raise ValueError(f"mlp_block_t: unsupported dtype {dt}")
    if C % 64 or C > 1024 or H % 64:
        raise ValueError(f"mlp_block_t: needs C % 64 == 0, C <= 1024 and "
                         f"H % 64 == 0 (C={C}, H={H})")
    dev = x.device
    f32 = torch.float32
    for t, name, dtype, shape in (
            (x, "x", dt, (B, D1, D2, C)), (res, "res", dt, (B, D1, D2, C)),
            (w1, "w1", dt, (C, H)), (b1, "b1", f32, (H,)),
            (w2, "w2", dt, (H, C)), (b2, "b2", f32, (C,)),
            (ln_s, "ln_s", f32, (C,)), (ln_b, "ln_b", f32, (C,))):
        _build.check_operand(t, name, dtype, shape, dev)
    out = torch.empty((B, D2, D1, C), dtype=dt, device=dev)
    lib = _build.load("mlp_block_t", {fn: _SIG for fn in _FN.values()})
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _FN[dt])(
            x.data_ptr(), res.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(),
            out.data_ptr(), B, D1, D2, C, H, float(eps), stream)
    _build.check(err, "mlp_block_t")
    mlp_block_t.launches += 1
    return out


mlp_block_t.launches = 0

"""The fused pre-LN attention stage of a MixSTE block.

`attention_stage` is the counterpart of `attention_stage_p` in the JAX
package (`d3dp_tpu/ops/attention.py`): LN1 -> qkv projection -> per-head
softmax attention -> out-projection -> residual -> LN2, returning
(x2, y2) with x2 = x + proj(attn(qkv(LN1(x)))) and y2 = LN2(x2).

On a CUDA tensor it launches the hand-written kernel in
`csrc/attention_stage.cu`; on a CPU tensor it runs `attention_stage_plain`,
the same math in plain torch ops and the same op order. There is no fallback
between the two: a CUDA input the kernel does not take raises.
"""

import ctypes

import torch

from d3dp_tpu_torch.ops import _build
from d3dp_tpu_torch.ops.common import layer_norm_rows, matmul_f32acc as _mm

HEAD_DIM = 64
MAX_TOKENS = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = [_P] * 13 + [_I, _I, _I, _I, _F, _F, _P]
_FN = {torch.bfloat16: "d3dp_attention_stage_bf16",
       torch.float32: "d3dp_attention_stage_f32"}


def attention_stage_plain(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                          num_heads, scale, eps):
    """Plain torch ops, in the order of the TPU kernel's production math.

    x: (R, N, C) in the compute dtype (fp32 or bf16); wqkv (C, 3C) and
    wp (C, C) in the compute dtype; biases and LN params fp32.
    fp32: p is divided by l before P.V. bf16: qkv rounds to bf16 after its
    bias, P.V runs on bf16 p with 1/l folded into the output, and the
    attention output rounds to bf16 before the projection.
    """
    R, N, C = x.shape
    dt = x.dtype
    d = C // num_heads
    x32 = x.float()
    y1 = layer_norm_rows(x32, ln1_s, ln1_b, eps)
    qkv = (_mm(y1.to(dt), wqkv) + bqkv.float()).to(dt)
    qkv = qkv.view(R, N, 3, num_heads, d).permute(2, 0, 3, 1, 4)  # (3,R,h,N,d)
    q, k, v = qkv[0], qkv[1], qkv[2]
    s = _mm(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dt == torch.float32:
        o = _mm(p / l, v)
    else:
        o = _mm(p.to(dt), v) * (1.0 / l)
    o = o.to(dt).permute(0, 2, 1, 3).reshape(R, N, C)
    branch = _mm(o, wp) + bp.float()
    x2 = x32 + branch
    y2 = layer_norm_rows(x2, ln2_s, ln2_b, eps)
    return x2.to(dt), y2.to(dt)


def attention_stage(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                    num_heads, scale, eps):
    """(x2, y2) of the attention stage; see the module docstring."""
    if x.device.type == "cpu":
        return attention_stage_plain(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b,
                                     ln2_s, ln2_b, num_heads, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"attention_stage: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (R, N, C), got {tuple(x.shape)}")
    R, N, C = x.shape
    dt = x.dtype
    if dt not in _FN:
        raise ValueError(f"attention_stage: unsupported dtype {dt}")
    if C != num_heads * HEAD_DIM or C % 64 or C > 1024:
        raise ValueError(f"attention_stage: needs head_dim {HEAD_DIM} and "
                         f"C % 64 == 0, C <= 1024 (C={C}, heads={num_heads})")
    if not 1 <= N <= MAX_TOKENS:
        raise ValueError(f"attention_stage: N={N} outside 1..{MAX_TOKENS}")
    dev = x.device
    f32 = torch.float32
    for t, name, dtype, shape in (
            (x, "x", dt, (R, N, C)), (wqkv, "wqkv", dt, (C, 3 * C)),
            (bqkv, "bqkv", f32, (3 * C,)), (wp, "wp", dt, (C, C)),
            (bp, "bp", f32, (C,)), (ln1_s, "ln1_s", f32, (C,)),
            (ln1_b, "ln1_b", f32, (C,)), (ln2_s, "ln2_s", f32, (C,)),
            (ln2_b, "ln2_b", f32, (C,))):
        _build.check_operand(t, name, dtype, shape, dev)
    qkv = torch.empty((R, N, 3 * C), dtype=dt, device=dev)
    o = torch.empty((R, N, C), dtype=dt, device=dev)
    x2 = torch.empty_like(x)
    y2 = torch.empty_like(x)
    lib = _build.load("attention_stage", {fn: _SIG for fn in _FN.values()})
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _FN[dt])(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), wp.data_ptr(),
            bp.data_ptr(), ln1_s.data_ptr(), ln1_b.data_ptr(),
            ln2_s.data_ptr(), ln2_b.data_ptr(), qkv.data_ptr(), o.data_ptr(),
            x2.data_ptr(), y2.data_ptr(), R, N, C, num_heads, float(scale),
            float(eps), stream)
    _build.check(err, "attention_stage")
    attention_stage.launches += 1
    return x2, y2


attention_stage.launches = 0

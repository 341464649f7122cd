"""MixSTE attention: the fused pre-LN stage and block (eval), the attention
core with its backward (training), and the packed-attention op.

`attention_stage` is the counterpart of `attention_stage_p` in the JAX
package (`d3dp_tpu/ops/attention.py`): LN1 -> qkv projection -> per-head
softmax attention -> out-projection -> residual -> LN2, returning
(x2, y2) with x2 = x + proj(attn(qkv(LN1(x)))) and y2 = LN2(x2) (fuse
level 4).

`attention_block` is the counterpart of `attention_block_p`: the same from
a precomputed qkv projection and a residual, (x2, y2) with x2 = res +
proj(attn(qkv)) (fuse levels 2 and 3).

`fused_attention_qkv` and `fused_attention_qkv_bwd` are the counterparts of
the JAX package's `fused_attention_qkv` and `_fused_attention_qkv_bwd`:
softmax attention read from the packed (R, N, 3C) qkv projection, and its
backward, which recomputes the softmax from qkv. `fused_attention_qkv_ad`
joins them as a `torch.autograd.Function` (the JAX `custom_vjp`).

`fused_attention_packed` and `fused_attention` are the counterparts of the
JAX package's public ops of the same names: softmax attention from separate
q, k, v, packed (B, N, h*d) or as (B, N, h, d).

On a CUDA tensor each op launches its hand-written kernel
(`csrc/attention_stage.cu`, `csrc/attention_block.cu`,
`csrc/attention_qkv.cu`); on a CPU tensor it runs its `*_plain` version, the
same math in plain torch ops and the same op order. There is no fallback
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
_SIG_FWD = [_P, _P, _I, _I, _I, _I, _F, _P]
_SIG_BWD = [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]
_QKV_FN = {torch.bfloat16: ("d3dp_attention_qkv_fwd_bf16", "d3dp_attention_qkv_bwd_bf16"),
           torch.float32: ("d3dp_attention_qkv_fwd_f32", "d3dp_attention_qkv_bwd_f32")}
_SIG_PACKED = [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]
_PACKED_FN = {torch.bfloat16: "d3dp_attention_packed_bf16",
              torch.float32: "d3dp_attention_packed_f32"}
_SIG_BLOCK = [_P] * 9 + [_I, _I, _I, _I, _F, _F, _P]
_BLOCK_FN = {torch.bfloat16: "d3dp_attention_block_bf16",
             torch.float32: "d3dp_attention_block_f32"}


def _split(t, parts, num_heads):
    """(R, N, parts*C) packed -> `parts` tensors of (R, h, N, d)."""
    R, N, PC = t.shape
    d = PC // (parts * num_heads)
    return t.reshape(R, N, parts, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)


def _merge(*xs):
    """(R, h, N, d) tensors -> (R, N, len(xs)*h*d) packed."""
    R, h, N, d = xs[0].shape
    return torch.stack(xs, dim=2).permute(0, 3, 2, 1, 4).reshape(R, N, len(xs) * h * d)


def attention_stage_plain(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                          num_heads, scale, eps):
    """Plain torch ops, in the order of the TPU kernel's production math.

    x: (R, N, C) in the compute dtype (fp32 or bf16); wqkv (C, 3C) and
    wp (C, C) in the compute dtype; biases and LN params fp32.
    fp32: p is divided by l before P.V. bf16: qkv rounds to bf16 after its
    bias, P.V runs on bf16 p with 1/l folded into the output, and the
    attention output rounds to bf16 before the projection.
    """
    dt = x.dtype
    x32 = x.float()
    y1 = layer_norm_rows(x32, ln1_s, ln1_b, eps)
    qkv = (_mm(y1.to(dt), wqkv) + bqkv.float()).to(dt)
    q, k, v = _split(qkv, 3, num_heads)
    s = _mm(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dt == torch.float32:
        o = _mm(p / l, v)
    else:
        o = _mm(p.to(dt), v) * (1.0 / l)
    branch = _mm(_merge(o.to(dt)), wp) + bp.float()
    x2 = x32 + branch
    y2 = layer_norm_rows(x2, ln2_s, ln2_b, eps)
    return x2.to(dt), y2.to(dt)


def _check_rows(x, num_heads, what, fns):
    """Device, rank, dtype, head and token-count checks of a (R, N, C)
    stage input; returns (R, N, C)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (R, N, C), got {tuple(x.shape)}")
    R, N, C = x.shape
    if x.dtype not in fns:
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")
    if C != num_heads * HEAD_DIM or C % 64 or C > 1024:
        raise ValueError(f"{what}: needs head_dim {HEAD_DIM} and "
                         f"C % 64 == 0, C <= 1024 (C={C}, heads={num_heads})")
    if not 1 <= N <= MAX_TOKENS:
        raise ValueError(f"{what}: N={N} outside 1..{MAX_TOKENS}")
    return R, N, C


def attention_stage(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                    num_heads, scale, eps):
    """(x2, y2) of the attention stage; see the module docstring."""
    if x.device.type == "cpu":
        return attention_stage_plain(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b,
                                     ln2_s, ln2_b, num_heads, scale, eps)
    R, N, C = _check_rows(x, num_heads, "attention_stage", _FN)
    dt = x.dtype
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


# ----------------------------------------------------- training attention core
def _attend_plain(q, k, v, scale):
    """The TPU kernels' per-head order (`_attn_head`): fp32 logits and
    softmax, p divided by l BEFORE the cast to the compute dtype, P.V
    accumulated in fp32 and rounded to the compute dtype. q, k, v:
    (R, h, N, d) -> (R, N, h*d)."""
    dt = q.dtype
    s = _mm(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    a = (p / p.sum(dim=-1, keepdim=True)).to(dt)
    return _merge(_mm(a, v).to(dt))


def fused_attention_qkv_plain(qkv, num_heads, scale):
    """Plain torch ops in the TPU kernel's order (`_attn_fused_qkv_kernel`).
    qkv: (R, N, 3C) -> (R, N, C)."""
    return _attend_plain(*_split(qkv, 3, num_heads), scale)


def fused_attention_qkv_bwd_plain(qkv, dout, num_heads, scale):
    """Plain torch ops of the TPU backward kernel (`_attn_bwd_kernel`):
    recompute P in fp32, then dV = bf16(P)^T dO, dP = dO V^T,
    dS = P o (dP - rowsum(dP o P)) * scale cast to the compute dtype,
    dQ = dS K, dK = dS^T Q, all accumulated in fp32.
    qkv (R, N, 3C), dout (R, N, C) -> d(qkv) (R, N, 3C) in qkv's dtype."""
    dt = qkv.dtype
    q, k, v = _split(qkv, 3, num_heads)
    (do,) = _split(dout, 1, num_heads)
    s = _mm(q, k.transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    dv = _mm(p.to(dt).transpose(-1, -2), do)
    dp = _mm(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    ds = (ds * scale).to(dt)
    dq = _mm(ds, k)
    dk = _mm(ds.transpose(-1, -2), q)
    return _merge(dq.to(dt), dk.to(dt), dv.to(dt))


def _check_qkv(qkv, num_heads, what):
    """Shape, dtype and head checks shared by the two kernels' wrappers."""
    if qkv.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"qkv must be (R, N, 3C), got {tuple(qkv.shape)}")
    R, N, C3 = qkv.shape
    C = C3 // 3
    if qkv.dtype not in _QKV_FN:
        raise ValueError(f"{what}: unsupported dtype {qkv.dtype}")
    if C != num_heads * HEAD_DIM or num_heads > 65535:
        raise ValueError(f"{what}: needs head_dim {HEAD_DIM} (C={C}, heads={num_heads})")
    if not 1 <= N <= MAX_TOKENS:
        raise ValueError(f"{what}: N={N} outside 1..{MAX_TOKENS}")
    _build.check_operand(qkv, "qkv", qkv.dtype, (R, N, C3), qkv.device)
    return R, N, C


def _qkv_lib():
    return _build.load("attention_qkv", {
        **{fns[0]: _SIG_FWD for fns in _QKV_FN.values()},
        **{fns[1]: _SIG_BWD for fns in _QKV_FN.values()},
        **{fn: _SIG_PACKED for fn in _PACKED_FN.values()}})


def fused_attention_qkv(qkv, num_heads, scale):
    """Softmax attention from the packed qkv projection, (R, N, 3C) ->
    (R, N, C); see the module docstring."""
    if qkv.device.type == "cpu":
        return fused_attention_qkv_plain(qkv, num_heads, scale)
    R, N, C = _check_qkv(qkv, num_heads, "fused_attention_qkv")
    dev = qkv.device
    out = torch.empty((R, N, C), dtype=qkv.dtype, device=dev)
    lib = _qkv_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _QKV_FN[qkv.dtype][0])(
            qkv.data_ptr(), out.data_ptr(), R, N, C, num_heads, float(scale), stream)
    _build.check(err, "fused_attention_qkv")
    fused_attention_qkv.launches += 1
    return out


def fused_attention_qkv_bwd(qkv, dout, num_heads, scale):
    """d(qkv) of `fused_attention_qkv` given the output gradient dout
    (R, N, C); the softmax is recomputed from qkv."""
    if qkv.device.type == "cpu":
        return fused_attention_qkv_bwd_plain(qkv, dout, num_heads, scale)
    R, N, C = _check_qkv(qkv, num_heads, "fused_attention_qkv_bwd")
    dev = qkv.device
    _build.check_operand(dout, "dout", qkv.dtype, (R, N, C), dev)
    dqkv = torch.empty_like(qkv)
    stats = torch.empty((R, num_heads, 3, N), dtype=torch.float32, device=dev)
    lib = _qkv_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _QKV_FN[qkv.dtype][1])(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), stats.data_ptr(), R, N, C,
            num_heads, float(scale), stream)
    _build.check(err, "fused_attention_qkv_bwd")
    fused_attention_qkv_bwd.launches += 1
    return dqkv


fused_attention_qkv.launches = 0
fused_attention_qkv_bwd.launches = 0


class _FusedAttentionQKV(torch.autograd.Function):
    """Forward saves only qkv; backward recomputes the softmax (the JAX
    package's `_ad_fwd` / `_ad_bwd`)."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return fused_attention_qkv(qkv, num_heads, scale)

    @staticmethod
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        return (fused_attention_qkv_bwd(qkv, dout.contiguous(), ctx.num_heads, ctx.scale),
                None, None)


def fused_attention_qkv_ad(qkv, num_heads, scale):
    """Differentiable `fused_attention_qkv`: the backward launches
    `fused_attention_qkv_bwd`."""
    return _FusedAttentionQKV.apply(qkv, num_heads, scale)


# ------------------------------------------------------------ attention block
def attention_block_plain(qkv, res, w, b, ln_s, ln_b, num_heads, scale, eps):
    """Plain torch ops in the TPU kernel's order (`_attn_block_kernel`): the
    attention core with p / l rounded to the compute dtype before P.V, its
    output rounded to the compute dtype before the projection, then
    x2 = res + (o W + b) and y2 = LN(x2) with fp32 statistics.
    qkv (R, N, 3C), res (R, N, C) -> (x2, y2), each (R, N, C)."""
    dt = qkv.dtype
    o = fused_attention_qkv_plain(qkv, num_heads, scale)
    x2 = res.float() + (_mm(o, w) + b.float())
    y2 = layer_norm_rows(x2, ln_s, ln_b, eps)
    return x2.to(dt), y2.to(dt)


def attention_block(qkv, res, w, b, ln_s, ln_b, num_heads, scale, eps):
    """(x2, y2) of the attention block; see the module docstring."""
    if qkv.device.type == "cpu":
        return attention_block_plain(qkv, res, w, b, ln_s, ln_b, num_heads, scale, eps)
    R, N, C = _check_rows(res, num_heads, "attention_block", _BLOCK_FN)
    dt = res.dtype
    dev = res.device
    f32 = torch.float32
    for t, name, dtype, shape in (
            (qkv, "qkv", dt, (R, N, 3 * C)), (res, "res", dt, (R, N, C)),
            (w, "w", dt, (C, C)), (b, "b", f32, (C,)),
            (ln_s, "ln_s", f32, (C,)), (ln_b, "ln_b", f32, (C,))):
        _build.check_operand(t, name, dtype, shape, dev)
    o = torch.empty((R, N, C), dtype=dt, device=dev)
    x2 = torch.empty_like(res)
    y2 = torch.empty_like(res)
    lib = _build.load("attention_block", {fn: _SIG_BLOCK for fn in _BLOCK_FN.values()})
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _BLOCK_FN[dt])(
            qkv.data_ptr(), res.data_ptr(), w.data_ptr(), b.data_ptr(), ln_s.data_ptr(),
            ln_b.data_ptr(), o.data_ptr(), x2.data_ptr(), y2.data_ptr(), R, N, C, num_heads,
            float(scale), float(eps), stream)
    _build.check(err, "attention_block")
    attention_block.launches += 1
    return x2, y2


attention_block.launches = 0


# ------------------------------------------------------- packed-heads attention
def fused_attention_plain(q, k, v, num_heads, scale):
    """Plain torch ops in the TPU kernel's order (`_attn_kernel`), from
    separate packed q, k, v, each (B, N, h*d) -> (B, N, h*d)."""
    return _attend_plain(*(_split(t, 1, num_heads)[0] for t in (q, k, v)), scale)


def fused_attention_packed(q, k, v, num_heads, scale):
    """Softmax attention from separate packed q, k, v, each (B, N, h*d) ->
    (B, N, h*d); see the module docstring."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, num_heads, scale)
    R, N, C = _check_rows(q, num_heads, "fused_attention_packed", _PACKED_FN)
    dev = q.device
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _build.check_operand(t, name, q.dtype, (R, N, C), dev)
    out = torch.empty((R, N, C), dtype=q.dtype, device=dev)
    lib = _qkv_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _PACKED_FN[q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), R, N, C, num_heads,
            float(scale), stream)
    _build.check(err, "fused_attention_packed")
    fused_attention_packed.launches += 1
    return out


fused_attention_packed.launches = 0


def fused_attention(q, k, v, scale):
    """(B, N, h, d) convenience wrapper of `fused_attention_packed` (free
    reshapes to and from the packed layout), as the JAX package's."""
    B, N, h, d = q.shape
    out = fused_attention_packed(q.reshape(B, N, h * d), k.reshape(B, N, h * d),
                                 v.reshape(B, N, h * d), h, scale)
    return out.reshape(B, N, h, d)

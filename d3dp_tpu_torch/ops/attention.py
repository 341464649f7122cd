"""MixSTE attention: the fused pre-LN stage and block, the attention core
with its backward, and the packed-attention op.

`attention_stage` is the counterpart of `attention_stage_p` in the JAX
package (`d3dp_tpu/ops/attention.py`): LN1 -> qkv projection -> per-head
softmax attention -> out-projection -> residual -> LN2, returning
(x2, y2) with x2 = x + proj(attn(qkv(LN1(x)))) and y2 = LN2(x2) (fuse
level 4). `attention_stage_dp` is `attention_stage_dp_p`: the same with the
branch, projection bias included, scaled per sequence by a DropPath scale
before the residual add (training at level 4). `attention_stage_hm` is the
head-major stage of the `hmqkv` lab variant (`_attn_stage_kernel_hm`): the
same function with the qkv weights stacked (h, C, 3d) outside the kernel
(`stack_head_major`).

The lab switches are read where the JAX package reads them, when an op is
called, and resolved as `_attention_stage_fwd` resolves them
(`stage_config`): `stage_variant` picks `D3DP_ATTN_VARIANT_T` (N >= 128)
or `D3DP_ATTN_VARIANT_S`, then `D3DP_ATTN_VARIANT`. "hmqkv" runs the
head-major stage (K8); every other value runs the stage kernel (K1) with
options: "", "loop", "batched", "pipelined", "phasesplit" and any unknown
value compute the production math (the TPU schedules differ in issue order
only); "bf16exp" (bf16) takes p = bf16(exp(bf16(s - m))) with l summed in
fp32 from it; "noy2" writes x2 alone and leaves y2 unwritten.
`D3DP_SOFTMAX_FOLD` other than 1 (bf16, K1 and K8) rounds p / l to bf16
before P.V instead of folding 1/l into the output. `D3DP_SPATIAL_GROUP=g`
on a stage of N <= 32 tokens whose R rows divide by g folds g sequences
into one of g*N tokens (a view) with a block-diagonal mask, each query
seeing only its own sequence's keys; under it "hmqkv" runs K1, and
"batched" raises as the JAX package's assert does. The DropPath form
never groups and keeps "", "batched" and "bf16exp", any other variant
running as "". The options reach the kernels as the `OPT_*` flags and the
mask block (`csrc/common.cuh`); the plain versions take the same.

`attention_block` is the counterpart of `attention_block_p`: the same from
a precomputed qkv projection and a residual, (x2, y2) with x2 = res +
proj(attn(qkv)) (fuse levels 2 and 3).

`attention_stage_partial` and `attention_block_partial` are the
tensor-parallel partial forms of the two (K1-tp, K6-tp): on a rank that
holds `num_heads` of the model's heads (its head-aligned share of qkv and
its rows of the out-projection, `parallel.mesh.shard_params`) they stop
after the projection and return its raw fp32 product, with no bias,
residual or LN2; the ranks' products are summed and `ops.residual_ln`
finishes the half. They take the stage's lab switches as the stage does
(`stage_config`); under "hmqkv" the stage's partial form is the head-major
one, `attention_stage_hm_partial` (K8-tp), on the rank's qkv stacked
head-major (`stack_head_major` of the rank's wqkv and bqkv).
`attention_stage_partial_ad` and `attention_block_partial_ad` are the two
with their backwards (plain torch ops around the attention core's backward
kernel on the rank's heads, as `attention_stage_bwd` and the block's
Function compute theirs), for `D3DP_TRAIN_FUSED=1` under tp.

`fused_attention_qkv` and `fused_attention_qkv_bwd` are the counterparts of
the JAX package's `fused_attention_qkv` and `_fused_attention_qkv_bwd`:
softmax attention read from the packed (R, N, 3C) qkv projection, and its
backward, which recomputes the softmax from qkv. `fused_attention_qkv_ad`
joins them as a `torch.autograd.Function` (the JAX `custom_vjp`).

Training with `D3DP_TRAIN_FUSED=1` differentiates the fused ops through
`torch.autograd.Function`s whose backwards are the JAX custom VJPs' math in
plain torch ops, in the forward's operand dtypes with fp32 accumulation:
`attention_stage_ad` / `attention_stage_dp_ad` (`_stage_bwd_impl`: LN1 and
qkv recomputed, the attention core through `fused_attention_qkv` and
`fused_attention_qkv_bwd`) and `attention_block_ad`
(`_attention_block_p_bwd`). The DropPath scale gets no gradient.

`attend_qkv` is the stage's attention phase alone (K1's attend launch) on a
packed qkv, with the stage's switches: a handle to time and test the
attention tile every kernel above shares. No model path calls it.

`fused_attention_packed` and `fused_attention` are the counterparts of the
JAX package's public ops of the same names: softmax attention from separate
q, k, v, packed (B, N, h*d) or as (B, N, h, d).

In fp32 the kernels multiply in three TF32 passes from the weights' hi and
lo planes (`ops.tf32`): those passed as `planes` (the model's weight cache
makes them once per weight version), else made at the call.

On a CUDA tensor each op launches its hand-written kernel
(`csrc/attention_stage.cu`, `csrc/attention_block.cu`,
`csrc/attention_qkv.cu`); on a CPU tensor it runs its `*_plain` version, the
same math in plain torch ops and the same op order. There is no fallback
between the two: a CUDA input the kernel does not take raises.
"""

import ctypes
import os

import torch

from d3dp_tpu_torch.ops import _build, tf32
from d3dp_tpu_torch.ops.common import layer_norm_rows, matmul_f32acc as _mm, matmul_f32out
from d3dp_tpu_torch.ops.norm import ln_bwd_rows, ln_stats

HEAD_DIM = 64
MAX_TOKENS = 256

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIG = [_P] * 13 + [_I] * 6 + [_F, _F, _P]
_SIG_DP = [_P] * 14 + [_I] * 6 + [_F, _F, _P]
_FN = {torch.bfloat16: "d3dp_attention_stage_bf16",
       torch.float32: "d3dp_attention_stage_f32"}
_DP_FN = {torch.bfloat16: "d3dp_attention_stage_dp_bf16",
          torch.float32: "d3dp_attention_stage_dp_f32"}
_HM_FN = {torch.bfloat16: "d3dp_attention_stage_hm_bf16",
          torch.float32: "d3dp_attention_stage_hm_f32"}
_SIG_FWD = [_P, _P, _I, _I, _I, _I, _F, _P]
# the backward: fp32 takes a stats scratch (above 32 keys its two launches'
# hand-over), bf16 none
_SIG_BWD = {torch.bfloat16: [_P, _P, _P, _I, _I, _I, _I, _F, _P],
            torch.float32: [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]}
_QKV_FN = {torch.bfloat16: ("d3dp_attention_qkv_fwd_bf16", "d3dp_attention_qkv_bwd_bf16"),
           torch.float32: ("d3dp_attention_qkv_fwd_f32", "d3dp_attention_qkv_bwd_f32")}
_SIG_PACKED = [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P]
_PACKED_FN = {torch.bfloat16: "d3dp_attention_packed_bf16",
              torch.float32: "d3dp_attention_packed_f32"}
_SIG_ATTEND = [_P, _P, _I, _I, _I, _I, _I, _I, _F, _P]
_ATTEND_FN = {torch.bfloat16: "d3dp_attend_packed_bf16",
              torch.float32: "d3dp_attend_packed_f32"}
_SIG_BLOCK = [_P] * 9 + [_I, _I, _I, _I, _F, _F, _P]
_BLOCK_FN = {torch.bfloat16: "d3dp_attention_block_bf16",
             torch.float32: "d3dp_attention_block_f32"}
_SIG_STAGE_PART = [_P] * 9 + [_I] * 6 + [_F, _F, _P]
_STAGE_PART_FN = {torch.bfloat16: "d3dp_attention_stage_partial_bf16",
                  torch.float32: "d3dp_attention_stage_partial_f32"}
_HM_PART_FN = {torch.bfloat16: "d3dp_attention_stage_hm_partial_bf16",
               torch.float32: "d3dp_attention_stage_hm_partial_f32"}
_SIG_BLOCK_PART = [_P] * 4 + [_I] * 4 + [_F, _P]
_BLOCK_PART_FN = {torch.bfloat16: "d3dp_attention_block_partial_bf16",
                  torch.float32: "d3dp_attention_block_partial_f32"}


# ------------------------------------------------------------- lab switches
def stage_variant(n_tokens=None):
    """The attention-stage variant the JAX package's `_stage_variant` picks
    for a stage of n_tokens tokens: the per-stage `D3DP_ATTN_VARIANT_T`
    (n_tokens >= 128) or `D3DP_ATTN_VARIANT_S` first (an empty value pins
    the default), then `D3DP_ATTN_VARIANT`, else "batched" for the temporal
    stage and "" for the spatial one; without n_tokens the global switch."""
    if n_tokens is not None:
        v = os.environ.get("D3DP_ATTN_VARIANT_T" if n_tokens >= 128 else "D3DP_ATTN_VARIANT_S")
        if v is not None:
            return v
        v = os.environ.get("D3DP_ATTN_VARIANT")
        if v is not None:
            return v
        return "batched" if n_tokens >= 128 else ""
    return os.environ.get("D3DP_ATTN_VARIANT", "")


def spatial_group():
    """`D3DP_SPATIAL_GROUP` as the JAX package reads it (0 when unset)."""
    v = os.environ.get("D3DP_SPATIAL_GROUP", "")
    return int(v) if v else 0


# the stage kernels' lab-switch flags (kOpt* in csrc/common.cuh)
OPT_NORM_FIRST = 1  # bf16: p / l rounded before P.V (D3DP_SOFTMAX_FOLD != 1)
OPT_BF16_EXP = 2  # bf16: p = bf16(exp(bf16(s - m))) (bf16exp)
OPT_NO_Y2 = 4  # x2 only, y2 left unwritten (noy2)


def fold_opts(dtype):
    """OPT_NORM_FIRST where `D3DP_SOFTMAX_FOLD` is other than 1 in bf16 (the
    JAX stage kernels' `fold_div`; fp32 always divides first), else 0."""
    return OPT_NORM_FIRST if (dtype == torch.bfloat16
                              and os.environ.get("D3DP_SOFTMAX_FOLD", "1") != "1") else 0


def stage_config(x, dp=False):
    """(kernel, opts, group) the lab switches select for the stage on x
    (R, N, C), resolved as the JAX package's `_attention_stage_fwd`:
    kernel "packed" (K1) or "head_major" (K8), opts the OPT_* flags, and
    group g > 1 where g sequences fold into one masked attention (1
    otherwise). dp: the DropPath form."""
    R, N = x.shape[0], x.shape[1]
    opts = fold_opts(x.dtype)
    g = 1 if dp else spatial_group()
    group = g if g > 1 and N <= 32 and R % g == 0 else 1
    v = stage_variant(N)
    if dp and v not in ("", "batched", "bf16exp"):
        v = ""  # the lab variants do not carry the DropPath input
    if v == "batched" and group > 1:
        raise ValueError(f"D3DP_SPATIAL_GROUP={g} and the batched attention variant do not "
                         "compose (the JAX stage kernel asserts the same)")
    if v == "hmqkv" and group == 1:
        return "head_major", opts, 1
    if v == "bf16exp" and x.dtype == torch.bfloat16:
        opts |= OPT_BF16_EXP
    if v == "noy2":
        opts |= OPT_NO_Y2
    return "packed", opts, group


def _split(t, parts, num_heads):
    """(R, N, parts*C) packed -> `parts` tensors of (R, h, N, d)."""
    R, N, PC = t.shape
    d = PC // (parts * num_heads)
    return t.reshape(R, N, parts, num_heads, d).permute(2, 0, 3, 1, 4).unbind(0)


def _merge(*xs):
    """(R, h, N, d) tensors -> (R, N, len(xs)*h*d) packed."""
    R, h, N, d = xs[0].shape
    return torch.stack(xs, dim=2).permute(0, 3, 2, 1, 4).reshape(R, N, len(xs) * h * d)


def stack_head_major(wqkv, bqkv, num_heads):
    """qkv weights (C, 3C) and bias (3C,) -> the head-major stacks of the
    `hmqkv` variant, (h, C, 3d) and (h, 1, 3d): head i's q, k and v columns
    side by side (JAX `_attention_stage_fwd`, `:789-799`). A tensor-parallel
    rank's (C, 3 C_l) and (3 C_l,) of its `num_heads` heads stack the same
    way, to the whole model's stacks sliced to those heads. Differentiable."""
    C = wqkv.shape[0]
    d = wqkv.shape[1] // (3 * num_heads)
    w = wqkv.reshape(C, 3, num_heads, d).permute(2, 0, 1, 3).reshape(num_heads, C, 3 * d)
    b = bqkv.reshape(3, num_heads, d).permute(1, 0, 2).reshape(num_heads, 1, 3 * d)
    return w.contiguous(), b.contiguous()


def _stage_attend_plain(q, k, v, scale, dt, opts=0, mask_block=0):
    """Attention from (R, h, N, d) q, k, v in the stage kernels' order, fp32
    (R, h, N, d) before its rounding to dt; opts and mask_block: the lab
    switches, as `attention_stage_plain` takes them."""
    s = _mm(q, k.transpose(-1, -2)) * scale
    if mask_block:
        blk = torch.arange(s.shape[-1], device=s.device) // mask_block
        s = s + torch.where(blk[:, None] == blk[None, :], 0.0, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    if opts & OPT_BF16_EXP and dt == torch.bfloat16:
        p = torch.exp((s - m).to(dt)).float()
    else:
        p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if dt == torch.float32:
        o = _mm(p / l, v)
    elif opts & OPT_NORM_FIRST:
        o = _mm((p / l).to(dt), v)
    else:
        o = _mm(p.to(dt), v) * (1.0 / l)
    return o


def _stage_tail_plain(x32, q, k, v, wp, bp, ln2_s, ln2_b, scale, eps, dt, dp_row, opts=0,
                      mask_block=0):
    """`_stage_attend_plain`, then the out-projection, the (DropPath-scaled)
    residual and LN2."""
    o = _stage_attend_plain(q, k, v, scale, dt, opts, mask_block)
    branch = _mm(_merge(o.to(dt)), wp) + bp.float()
    if dp_row is not None:
        branch = branch * dp_row.float()[:, None, None]
    x2 = x32 + branch
    if opts & OPT_NO_Y2:
        return x2.to(dt), torch.empty_like(x2, dtype=dt)
    y2 = layer_norm_rows(x2, ln2_s, ln2_b, eps)
    return x2.to(dt), y2.to(dt)


def attention_stage_plain(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                          num_heads, scale, eps, dp_row=None, opts=0, mask_block=0):
    """Plain torch ops, in the order of the TPU kernel's math.

    x: (R, N, C) in the compute dtype (fp32 or bf16); wqkv (C, 3C) and
    wp (C, C) in the compute dtype; biases and LN params fp32.
    fp32: p is divided by l before P.V. bf16: qkv rounds to bf16 after its
    bias, P.V runs on bf16 p with 1/l folded into the output, and the
    attention output rounds to bf16 before the projection. dp_row (R,)
    fp32: the DropPath form's branch scales. opts: the OPT_* lab switches
    (OPT_NORM_FIRST: p / l rounded to bf16 before P.V; OPT_BF16_EXP:
    p = bf16(exp(bf16(s - m))), l its fp32 sum; OPT_NO_Y2: y2 left
    unwritten). mask_block > 0: x holds whole blocks of mask_block tokens
    (the grouped fold) and JAX's additive -1e30 block-diagonal mask keeps
    each query to its own block.
    """
    dt = x.dtype
    x32 = x.float()
    y1 = layer_norm_rows(x32, ln1_s, ln1_b, eps)
    qkv = (_mm(y1.to(dt), wqkv) + bqkv.float()).to(dt)
    q, k, v = _split(qkv, 3, num_heads)
    return _stage_tail_plain(x32, q, k, v, wp, bp, ln2_s, ln2_b, scale, eps, dt, dp_row, opts,
                             mask_block)


def attention_stage_dp_plain(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b, dp_row,
                             num_heads, scale, eps, opts=0):
    """`attention_stage_plain` with the branch scaled by dp_row (R,)."""
    return attention_stage_plain(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                                 num_heads, scale, eps, dp_row=dp_row, opts=opts)


def attention_stage_hm_plain(x, wqkv_hm, bqkv_hm, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                             num_heads, scale, eps, opts=0):
    """Plain torch ops of the head-major stage (`_attn_stage_kernel_hm`):
    per-head qkv projections from the (h, C, 3d) stack, rounded to the
    compute dtype after their bias, then the stage's attention and tail
    (opts: OPT_NORM_FIRST, the one switch the JAX kernel reads)."""
    dt = x.dtype
    x32 = x.float()
    y1 = layer_norm_rows(x32, ln1_s, ln1_b, eps).to(dt)
    qkv = torch.stack([(_mm(y1, wqkv_hm[i]) + bqkv_hm[i].float()).to(dt)
                       for i in range(num_heads)], dim=1)  # (R, h, N, 3d)
    q, k, v = qkv.chunk(3, dim=-1)
    return _stage_tail_plain(x32, q, k, v, wp, bp, ln2_s, ln2_b, scale, eps, dt, None, opts)


def check_stage_shape(what, C, dtype):
    """Raise unless the stage kernels' GEMM steps take C channels in dtype:
    the wgmma walks of csrc/stage.cuh (C / 2 output columns a warpgroup in
    64-column blocks) take C % 128 == 0, C <= 512 in bf16 and fp32."""
    if C % 128 or not 0 < C <= 512:
        raise ValueError(f"{what}: needs C % 128 == 0 and C <= 512 in {dtype} (C={C})")


def _check_rows(x, num_heads, what, fns, mask_block=0, partial=False):
    """Device, rank, dtype, head and token-count checks of a (R, N, C)
    stage input (N whole blocks of mask_block <= 32 tokens where masked);
    returns (R, N, C). partial: a tensor-parallel rank's `num_heads` heads,
    C_l = num_heads * 64 of the C channels, any count down to one (the qkv
    walks end an odd count in a 64-column chunk)."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"x must be (R, N, C), got {tuple(x.shape)}")
    R, N, C = x.shape
    if x.dtype not in fns:
        raise ValueError(f"{what}: unsupported dtype {x.dtype}")
    if partial:
        c_l = num_heads * HEAD_DIM
        if num_heads < 1 or C % c_l:
            raise ValueError(f"{what}: a rank's {num_heads} heads of {HEAD_DIM} do not split "
                             f"C={C}")
    elif C != num_heads * HEAD_DIM:
        raise ValueError(f"{what}: needs head_dim {HEAD_DIM} (C={C}, heads={num_heads})")
    check_stage_shape(what, C, x.dtype)
    if mask_block:
        if not 1 <= mask_block <= 32 or N % mask_block:
            raise ValueError(f"{what}: N={N} is not whole blocks of {mask_block} <= 32 tokens")
    elif not 1 <= N <= MAX_TOKENS:
        raise ValueError(f"{what}: N={N} outside 1..{MAX_TOKENS}")
    return R, N, C


def _stage_lib():
    """attention_stage.cu's library, every entry point bound."""
    return _build.load("attention_stage", {
        **{fn: _SIG for fn in _FN.values()}, **{fn: _SIG for fn in _HM_FN.values()},
        **{fn: _SIG_DP for fn in _DP_FN.values()},
        **{fn: _SIG_STAGE_PART for fn in _STAGE_PART_FN.values()},
        **{fn: _SIG_STAGE_PART for fn in _HM_PART_FN.values()}})


def _launch_stage(what, fns, sig, x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                  dp_row, num_heads, scale, eps, head_major=False, opts=0, mask_block=0,
                  planes=None):
    """Check the operands of one of the stage's three forms and launch it
    with the lab switches opts and mask_block; returns (x2, y2). fp32 runs
    on (wqkv, wp)'s TF32 planes: `planes`, else made here
    (`ops.tf32.operands`)."""
    R, N, C = _check_rows(x, num_heads, what, fns, mask_block)
    dt = x.dtype
    dev = x.device
    f32 = torch.float32
    d3 = 3 * HEAD_DIM
    wshape, bshape = ((num_heads, C, d3), (num_heads, 1, d3)) if head_major else \
        ((C, 3 * C), (3 * C,))
    checks = [(x, "x", dt, (R, N, C)), (wqkv, "wqkv", dt, wshape), (bqkv, "bqkv", f32, bshape),
              (wp, "wp", dt, (C, C)), (bp, "bp", f32, (C,)), (ln1_s, "ln1_s", f32, (C,)),
              (ln1_b, "ln1_b", f32, (C,)), (ln2_s, "ln2_s", f32, (C,)),
              (ln2_b, "ln2_b", f32, (C,))]
    if dp_row is not None:
        checks.append((dp_row, "dp_row", f32, (R,)))
    for t, name, dtype, shape in checks:
        _build.check_operand(t, name, dtype, shape, dev)
    if dt == f32:
        wqkv, wp = tf32.operands((wqkv, wp), ("wqkv", "wp"), dev, planes)
    qkv = torch.empty((R, N, 3 * C), dtype=dt, device=dev)  # (h, R*N, 3d) when head-major
    o = torch.empty((R, N, C), dtype=dt, device=dev)
    x2 = torch.empty_like(x)
    y2 = torch.empty_like(x)
    lib = _stage_lib()
    weights = [x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b]
    ptrs = [t.data_ptr() for t in weights + ([dp_row] if dp_row is not None else [])]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fns[dt])(*ptrs, qkv.data_ptr(), o.data_ptr(), x2.data_ptr(),
                                    y2.data_ptr(), R, N, C, num_heads, opts, mask_block,
                                    float(scale), float(eps), stream)
    _build.check(err, what)
    return x2, y2


def attention_stage(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                    num_heads, scale, eps, planes=None):
    """(x2, y2) of the attention stage under the lab switches
    (`stage_config`; see the module docstring). Under the `hmqkv` variant
    it stacks the weights head-major and runs `attention_stage_hm`, as the
    JAX package does; grouped, it runs on the (R/g, g*N, C) view of x with
    the block mask. planes: fp32's (wqkv, wp) TF32 planes, or None."""
    kernel, opts, group = stage_config(x)
    if kernel == "head_major":
        return attention_stage_hm(x, *stack_head_major(wqkv, bqkv, num_heads), wp, bp, ln1_s,
                                  ln1_b, ln2_s, ln2_b, num_heads, scale, eps,
                                  planes=None if planes is None else (None, planes[1]))
    R, N, C = x.shape
    mask_block = N if group > 1 else 0
    xg = x.view(R // group, group * N, C) if group > 1 else x
    if x.device.type == "cpu":
        x2, y2 = attention_stage_plain(xg, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                                       num_heads, scale, eps, opts=opts, mask_block=mask_block)
    else:
        x2, y2 = _launch_stage("attention_stage", _FN, _SIG, xg, wqkv, bqkv, wp, bp, ln1_s,
                               ln1_b, ln2_s, ln2_b, None, num_heads, scale, eps, opts=opts,
                               mask_block=mask_block, planes=planes)
        attention_stage.launches += 1
    return x2.view(R, N, C), y2.view(R, N, C)


def attention_stage_dp(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b, dp_row,
                       num_heads, scale, eps, planes=None):
    """(x2, y2) of the attention stage with the branch, projection bias
    included, scaled by dp_row (R,) fp32 before the residual add; the lab
    switches as `stage_config(x, dp=True)` resolves them; planes as
    `attention_stage`'s."""
    _, opts, _ = stage_config(x, dp=True)
    if x.device.type == "cpu":
        return attention_stage_dp_plain(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                                        dp_row, num_heads, scale, eps, opts=opts)
    out = _launch_stage("attention_stage_dp", _DP_FN, _SIG_DP, x, wqkv, bqkv, wp, bp, ln1_s,
                        ln1_b, ln2_s, ln2_b, dp_row, num_heads, scale, eps, opts=opts,
                        planes=planes)
    attention_stage_dp.launches += 1
    return out


def attention_stage_hm(x, wqkv_hm, bqkv_hm, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                       num_heads, scale, eps, planes=None):
    """(x2, y2) of the head-major attention stage (the `hmqkv` variant's
    kernel): qkv weights (h, C, 3d) and bias (h, 1, 3d) from
    `stack_head_major`, the rest as `attention_stage`; `D3DP_SOFTMAX_FOLD`
    is the one switch it reads (`fold_opts`). planes: fp32's (wqkv_hm, wp)
    TF32 planes, or None."""
    opts = fold_opts(x.dtype)
    if x.device.type == "cpu":
        return attention_stage_hm_plain(x, wqkv_hm, bqkv_hm, wp, bp, ln1_s, ln1_b, ln2_s,
                                        ln2_b, num_heads, scale, eps, opts=opts)
    out = _launch_stage("attention_stage_hm", _HM_FN, _SIG, x, wqkv_hm, bqkv_hm, wp, bp, ln1_s,
                        ln1_b, ln2_s, ln2_b, None, num_heads, scale, eps, head_major=True,
                        opts=opts, planes=planes)
    attention_stage_hm.launches += 1
    return out


attention_stage.launches = 0
attention_stage_dp.launches = 0
attention_stage_hm.launches = 0


# ------------------------------------------------- tensor-parallel partial forms
def attention_stage_partial_plain(x, wqkv, bqkv, ln1_s, ln1_b, wp, num_heads, scale, eps, opts=0,
                                  mask_block=0):
    """Plain torch ops of K1-tp in the stage's order: LN1 over the whole
    row, qkv over the rank's `num_heads` heads (wqkv (C, 3 C_l) with their
    q, k and v columns, bqkv (3 C_l,), C_l = num_heads * 64), the stage's
    attention, then o (R, N, C_l) @ wp (C_l, C) -> the fp32 (R, N, C)
    product, no bias, residual or LN2. opts, mask_block: as
    `attention_stage_plain`'s (OPT_NO_Y2 has no meaning here)."""
    dt = x.dtype
    y1 = layer_norm_rows(x.float(), ln1_s, ln1_b, eps)
    qkv = (_mm(y1.to(dt), wqkv) + bqkv.float()).to(dt)
    o = _stage_attend_plain(*_split(qkv, 3, num_heads), scale, dt, opts, mask_block)
    return _mm(_merge(o.to(dt)), wp)


def attention_stage_hm_partial_plain(x, wqkv_hm, bqkv_hm, ln1_s, ln1_b, wp, num_heads, scale,
                                     eps, opts=0):
    """Plain torch ops of K8-tp in the head-major stage's order: LN1 over
    the whole row, the rank's `num_heads` heads' qkv from their head-major
    stacks (h_l, C, 3d) and (h_l, 1, 3d) (`stack_head_major` of the rank's
    wqkv and bqkv), the stage's attention, then o (R, N, C_l) @ wp (C_l, C)
    -> the fp32 (R, N, C) product, no bias, residual or LN2. opts:
    OPT_NORM_FIRST, the one switch the head-major stage reads."""
    dt = x.dtype
    y1 = layer_norm_rows(x.float(), ln1_s, ln1_b, eps).to(dt)
    qkv = torch.stack([(_mm(y1, wqkv_hm[i]) + bqkv_hm[i].float()).to(dt)
                       for i in range(num_heads)], dim=1)  # (R, h_l, N, 3d)
    o = _stage_attend_plain(*qkv.chunk(3, dim=-1), scale, dt, opts)
    return _mm(_merge(o.to(dt)), wp)


def _launch_partial(what, fns, x, wqkv, bqkv, ln1_s, ln1_b, wp, num_heads, scale, eps, opts,
                    mask_block=0, head_major=False):
    """Check the operands of K1-tp (packed wqkv (C, 3 C_l), bqkv (3 C_l,))
    or K8-tp (head-major (h_l, C, 3d), (h_l, 1, 3d)) and launch it; returns
    the fp32 (R, N, C) partial. fp32 runs on (wqkv, wp)'s TF32 planes, made
    here (`ops.tf32.operands`): the rank's weights change every step."""
    R, N, C = _check_rows(x, num_heads, what, fns, mask_block, partial=True)
    dt, dev, f32 = x.dtype, x.device, torch.float32
    c_l = num_heads * HEAD_DIM
    d3 = 3 * HEAD_DIM
    wshape, bshape = ((num_heads, C, d3), (num_heads, 1, d3)) if head_major else \
        ((C, 3 * c_l), (3 * c_l,))
    for t, name, dtype, shape in (
            (x, "x", dt, (R, N, C)), (wqkv, "wqkv", dt, wshape), (bqkv, "bqkv", f32, bshape),
            (ln1_s, "ln1_s", f32, (C,)), (ln1_b, "ln1_b", f32, (C,)), (wp, "wp", dt, (c_l, C))):
        _build.check_operand(t, name, dtype, shape, dev)
    if dt == f32:
        wqkv, wp = tf32.operands((wqkv, wp), ("wqkv", "wp"), dev)
    # qkv scratch: (R, N, 3 C_l) packed, (h_l, R*N, 3d) head-major
    qkv = torch.empty((R, N, 3 * c_l), dtype=dt, device=dev)
    o = torch.empty((R, N, c_l), dtype=dt, device=dev)
    part = torch.empty((R, N, C), dtype=f32, device=dev)
    lib = _stage_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fns[dt])(
            x.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(), ln1_s.data_ptr(), ln1_b.data_ptr(),
            wp.data_ptr(), qkv.data_ptr(), o.data_ptr(), part.data_ptr(), R, N, C, num_heads,
            opts, mask_block, float(scale), float(eps), stream)
    _build.check(err, what)
    return part


def attention_stage_hm_partial(x, wqkv_hm, bqkv_hm, ln1_s, ln1_b, wp, num_heads, scale, eps):
    """K8-tp: a tensor-parallel rank's share of the head-major stage (the
    `hmqkv` variant) on x (R, N, C), its fp32 (R, N, C) out-projection
    product; see `attention_stage_hm_partial_plain`. `D3DP_SOFTMAX_FOLD` is
    the one switch it reads (`fold_opts`)."""
    opts = fold_opts(x.dtype)
    if x.device.type == "cpu":
        return attention_stage_hm_partial_plain(x, wqkv_hm, bqkv_hm, ln1_s, ln1_b, wp,
                                                num_heads, scale, eps, opts)
    part = _launch_partial("attention_stage_hm_partial", _HM_PART_FN, x, wqkv_hm, bqkv_hm,
                           ln1_s, ln1_b, wp, num_heads, scale, eps, opts, head_major=True)
    attention_stage_hm_partial.launches += 1
    return part


def attention_stage_partial(x, wqkv, bqkv, ln1_s, ln1_b, wp, num_heads, scale, eps):
    """K1-tp: a tensor-parallel rank's share of the attention stage on x
    (R, N, C), its fp32 (R, N, C) out-projection product (see
    `attention_stage_partial_plain`), under the lab switches as
    `attention_stage` resolves them: under `hmqkv` it stacks the rank's
    weights head-major and runs `attention_stage_hm_partial` (K8-tp)."""
    kernel, opts, group = stage_config(x)
    if kernel == "head_major":
        return attention_stage_hm_partial(x, *stack_head_major(wqkv, bqkv, num_heads), ln1_s,
                                          ln1_b, wp, num_heads, scale, eps)
    opts &= ~OPT_NO_Y2
    R, N, C = x.shape
    mask_block = N if group > 1 else 0
    xg = x.view(R // group, group * N, C) if group > 1 else x
    if x.device.type == "cpu":
        part = attention_stage_partial_plain(xg, wqkv, bqkv, ln1_s, ln1_b, wp, num_heads, scale,
                                             eps, opts, mask_block)
        return part.view(R, N, C)
    part = _launch_partial("attention_stage_partial", _STAGE_PART_FN, xg, wqkv, bqkv, ln1_s,
                           ln1_b, wp, num_heads, scale, eps, opts, mask_block)
    attention_stage_partial.launches += 1
    return part.view(R, N, C)


attention_stage_partial.launches = 0
attention_stage_hm_partial.launches = 0


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
        **{fns[1]: _SIG_BWD[dt] for dt, fns in _QKV_FN.items()},
        **{fn: _SIG_PACKED for fn in _PACKED_FN.values()},
        **{fn: _SIG_ATTEND for fn in _ATTEND_FN.values()}})


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
    # fp32 above 32 keys: the query pass hands (m, 1/l, D) per row and head to
    # the key pass, in runs of N rounded up to the 64-row tile; the other
    # bodies keep them in shared memory
    stats = []
    if qkv.dtype == torch.float32:
        stats = [torch.empty((R, num_heads, 3, -(-N // 64) * 64), dtype=torch.float32,
                             device=dev)]
    lib = _qkv_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _QKV_FN[qkv.dtype][1])(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), *[t.data_ptr() for t in stats],
            R, N, C, num_heads, float(scale), stream)
    _build.check(err, "fused_attention_qkv_bwd")
    fused_attention_qkv_bwd.launches += 1
    return dqkv


fused_attention_qkv.launches = 0
fused_attention_qkv_bwd.launches = 0


def attend_qkv_plain(qkv, num_heads, scale, opts=0):
    """Plain torch ops of the attention stage's attention phase alone, in its
    order (`_stage_attend_plain`), from the packed (R, N, 3C) qkv ->
    (R, N, C) in qkv's dtype."""
    o = _stage_attend_plain(*_split(qkv, 3, num_heads), scale, qkv.dtype, opts)
    return _merge(o.to(qkv.dtype))


def attend_qkv(qkv, num_heads, scale, opts=0):
    """The attention stage's attend launch alone (the second of K1's three
    launches, the tile every attention kernel shares) on a packed qkv, with
    the stage's switches as flags (OPT_NORM_FIRST, OPT_BF16_EXP): a way to
    time and test that launch by itself. No model path calls it."""
    if qkv.device.type == "cpu":
        return attend_qkv_plain(qkv, num_heads, scale, opts)
    R, N, C = _check_qkv(qkv, num_heads, "attend_qkv")
    out = torch.empty((R, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = _qkv_lib()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = getattr(lib, _ATTEND_FN[qkv.dtype])(
            qkv.data_ptr(), out.data_ptr(), R, N, C, num_heads, opts, 0, float(scale), stream)
    _build.check(err, "attend_qkv")
    attend_qkv.launches += 1
    return out


attend_qkv.launches = 0


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


# ------------------------------------------------- the stage's backward (training)
def _stage_branch_bwd(x, wqkv, bqkv, wp, ln1_s, ln1_b, ds_b, num_heads, scale, eps):
    """The stage's branch backward given the fp32 gradient ds_b (R*N, C) of
    its projection output (o @ wp, before bias and residual): LN1 and the
    qkv projection recomputed (qkv in the compute dtype with its bias added
    there, as the JAX backward does), the attention core through
    `fused_attention_qkv` and `fused_attention_qkv_bwd`, products on
    compute-dtype operands with fp32 accumulation. `num_heads` heads of wqkv
    (C, 3 C_l): the whole stage's, or a tensor-parallel rank's. Returns (dx
    of LN1's input in fp32 (R*N, C), dwqkv, dbqkv, dwp, dln1_s, dln1_b);
    weight and bias gradients in the dtype of wqkv / wp."""
    R, N, C = x.shape
    g = spatial_group()
    if g > 1 and N <= 32 and R % g == 0:
        raise NotImplementedError("D3DP_SPATIAL_GROUP is an eval/sampling-path optimization; "
                                  "the stage backward recomputes ungrouped attention -- unset "
                                  "it for training")
    md = x.dtype
    f32 = torch.float32
    c3 = wqkv.shape[1]
    xhat, rstd = ln_stats(x.float().reshape(R * N, C), eps)
    y1 = (xhat * ln1_s.float() + ln1_b.float()).to(md)
    qkv = (matmul_f32out(y1, wqkv).to(md) + bqkv.to(md)).reshape(R, N, c3)
    a = fused_attention_qkv(qkv, num_heads, scale)

    ds_m = ds_b.to(md)
    dwp = matmul_f32out(a.reshape(R * N, c3 // 3).to(md).t(), ds_m).to(wp.dtype)
    da = matmul_f32out(ds_m, wp.t()).to(qkv.dtype).reshape(R, N, c3 // 3)
    dqkv = fused_attention_qkv_bwd(qkv, da, num_heads, scale)

    dqkv_m = dqkv.reshape(R * N, c3).to(md)
    dbqkv = dqkv_m.to(f32).sum(dim=0).to(wqkv.dtype)
    dwqkv = matmul_f32out(y1.t(), dqkv_m).to(wqkv.dtype)
    dy1 = matmul_f32out(dqkv_m, wqkv.t())

    # LN1 backward on the recomputed statistics
    gs1 = dy1 * ln1_s.float()
    dx1 = rstd * (gs1 - gs1.mean(dim=-1, keepdim=True)
                  - xhat * (gs1 * xhat).mean(dim=-1, keepdim=True))
    dln1_s = (dy1 * xhat).sum(dim=0).to(ln1_s.dtype)
    dln1_b = dy1.sum(dim=0).to(ln1_s.dtype)
    return dx1, dwqkv, dbqkv, dwp, dln1_s, dln1_b


def attention_stage_bwd(x, wqkv, bqkv, wp, ln1_s, ln1_b, ln2_s, x2, gx2, gy2, num_heads,
                        scale, eps, dp_row=None):
    """Gradients of `attention_stage` (or `attention_stage_dp`) given those
    of (x2, y2): the JAX package's `_stage_bwd_impl` in plain torch ops, the
    LN2 backward on x2, then `_stage_branch_bwd`. With dp_row the
    branch-side cotangent is dp_row * ds while the residual's stays
    unscaled. Returns (dx, dwqkv, dbqkv, dwp, dbp, dln1_s, dln1_b, dln2_s,
    dln2_b); weight and bias gradients in the dtype of wqkv / wp, as the JAX
    VJP returns them."""
    R, N, C = x.shape
    ds, dln2_s, dln2_b = ln_bwd_rows(x2.reshape(R * N, C).float(), ln2_s,
                                     gy2.reshape(R * N, C), eps)
    if gx2 is not None:
        ds = ds + gx2.reshape(R * N, C).float()
    # x2 = x + [dp *] (a @ wp + bp)
    ds_b = ds if dp_row is None else ds * dp_row.float().repeat_interleave(N)[:, None]
    dbp = ds_b.sum(dim=0).to(wp.dtype)
    dx1, dwqkv, dbqkv, dwp, dln1_s, dln1_b = _stage_branch_bwd(
        x, wqkv, bqkv, wp, ln1_s, ln1_b, ds_b, num_heads, scale, eps)
    dx = (ds + dx1).reshape(R, N, C).to(x.dtype)
    return (dx, dwqkv, dbqkv, dwp, dbp, dln1_s, dln1_b, dln2_s.to(ln2_s.dtype),
            dln2_b.to(ln2_s.dtype))


class _AttentionStage(torch.autograd.Function):
    """Forward: `attention_stage` (K1, or K8 under `hmqkv`) or, with dp_row,
    `attention_stage_dp`; backward: `attention_stage_bwd` (the JAX
    `attention_stage_p` / `attention_stage_dp_p` custom VJPs)."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b, dp_row, num_heads,
                scale, eps):
        if dp_row is None:
            x2, y2 = attention_stage(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                                     num_heads, scale, eps)
        else:
            x2, y2 = attention_stage_dp(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b,
                                        dp_row, num_heads, scale, eps)
        ctx.save_for_backward(x, wqkv, bqkv, wp, ln1_s, ln1_b, ln2_s, x2, dp_row)
        ctx.cfg = (num_heads, scale, eps)
        return x2, y2

    @staticmethod
    def backward(ctx, gx2, gy2):
        x, wqkv, bqkv, wp, ln1_s, ln1_b, ln2_s, x2, dp_row = ctx.saved_tensors
        grads = attention_stage_bwd(x, wqkv, bqkv, wp, ln1_s, ln1_b, ln2_s, x2, gx2, gy2,
                                    *ctx.cfg, dp_row=dp_row)
        return (*grads, None, None, None, None)


def attention_stage_ad(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b, num_heads, scale,
                       eps):
    """Differentiable `attention_stage` (the JAX `attention_stage_p`)."""
    return _AttentionStage.apply(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b, None,
                                 num_heads, scale, eps)


def attention_stage_dp_ad(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b, dp_row, num_heads,
                          scale, eps):
    """Differentiable `attention_stage_dp` (the JAX `attention_stage_dp_p`);
    dp_row gets no gradient."""
    return _AttentionStage.apply(x, wqkv, bqkv, wp, bp, ln1_s, ln1_b, ln2_s, ln2_b, dp_row,
                                 num_heads, scale, eps)


class _AttentionStagePartial(torch.autograd.Function):
    """Forward: `attention_stage_partial` (K1-tp, or K8-tp under `hmqkv`);
    backward: `_stage_branch_bwd` on the rank's heads given the gradient of
    the fp32 partial. x, ln1_s and ln1_b get the rank's share of their
    gradients: the caller passes them through `parallel.tp.copy_to_tp`,
    whose backward sums the shares over the tp group."""

    @staticmethod
    def forward(ctx, x, wqkv, bqkv, ln1_s, ln1_b, wp, num_heads, scale, eps):
        part = attention_stage_partial(x, wqkv, bqkv, ln1_s, ln1_b, wp, num_heads, scale, eps)
        ctx.save_for_backward(x, wqkv, bqkv, ln1_s, ln1_b, wp)
        ctx.cfg = (num_heads, scale, eps)
        return part

    @staticmethod
    def backward(ctx, gpart):
        x, wqkv, bqkv, ln1_s, ln1_b, wp = ctx.saved_tensors
        R, N, C = x.shape
        dx1, dwqkv, dbqkv, dwp, dln1_s, dln1_b = _stage_branch_bwd(
            x, wqkv, bqkv, wp, ln1_s, ln1_b, gpart.reshape(R * N, C).float(), *ctx.cfg)
        return (dx1.reshape(R, N, C).to(x.dtype), dwqkv, dbqkv, dln1_s, dln1_b, dwp,
                None, None, None)


def attention_stage_partial_ad(x, wqkv, bqkv, ln1_s, ln1_b, wp, num_heads, scale, eps):
    """Differentiable `attention_stage_partial` (K1-tp, or K8-tp under
    `hmqkv`): a tensor-parallel rank's fp32 partial of the stage, whose
    backward is the JAX stage VJP's branch part on the rank's heads."""
    return _AttentionStagePartial.apply(x, wqkv, bqkv, ln1_s, ln1_b, wp, num_heads, scale, eps)


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


def attention_block(qkv, res, w, b, ln_s, ln_b, num_heads, scale, eps, planes=None):
    """(x2, y2) of the attention block; see the module docstring. planes:
    fp32's (w,) TF32 planes, or None."""
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
    if dt == f32:
        w, = tf32.operands((w,), ("w",), dev, planes)
    o = torch.empty((R, N, C), dtype=dt, device=dev)
    x2 = torch.empty_like(res)
    y2 = torch.empty_like(res)
    lib = _block_lib()
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


def _block_lib():
    """attention_block.cu's library, both forms bound."""
    return _build.load("attention_block", {
        **{fn: _SIG_BLOCK for fn in _BLOCK_FN.values()},
        **{fn: _SIG_BLOCK_PART for fn in _BLOCK_PART_FN.values()}})


def attention_block_partial_plain(qkv, wp, num_heads, scale):
    """Plain torch ops of K6-tp: the block's attention on the rank's
    `num_heads` heads of qkv (R, N, 3 C_l) in `attention_block_plain`'s
    order, then o @ wp (C_l, C) -> the fp32 (R, N, C) product, no bias,
    residual or LN2."""
    return _mm(fused_attention_qkv_plain(qkv, num_heads, scale), wp)


def attention_block_partial(qkv, wp, num_heads, scale):
    """K6-tp: a tensor-parallel rank's share of the attention block (levels
    2-3), its fp32 (R, N, C) out-projection product; see
    `attention_block_partial_plain`; fp32 makes wp's TF32 planes here."""
    if qkv.device.type == "cpu":
        return attention_block_partial_plain(qkv, wp, num_heads, scale)
    R, N, c_l = _check_qkv(qkv, num_heads, "attention_block_partial")
    dt, dev = qkv.dtype, qkv.device
    if wp.dim() != 2 or wp.shape[0] != c_l:
        raise ValueError(f"wp must be ({c_l}, C), got {tuple(wp.shape)}")
    C = wp.shape[1]
    check_stage_shape("attention_block_partial", C, dt)
    if C % c_l:
        raise ValueError(f"attention_block_partial: {num_heads} heads do not split C={C}")
    _build.check_operand(wp, "wp", dt, (c_l, C), dev)
    if dt == torch.float32:
        wp, = tf32.operands((wp,), ("wp",), dev)
    o = torch.empty((R, N, c_l), dtype=dt, device=dev)
    part = torch.empty((R, N, C), dtype=torch.float32, device=dev)
    lib = _block_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _BLOCK_PART_FN[dt])(qkv.data_ptr(), wp.data_ptr(), o.data_ptr(),
                                               part.data_ptr(), R, N, C, num_heads, float(scale),
                                               stream)
    _build.check(err, "attention_block_partial")
    attention_block_partial.launches += 1
    return part


attention_block_partial.launches = 0


class _AttentionBlock(torch.autograd.Function):
    """Forward: `attention_block`; backward: the JAX package's
    `_attention_block_p_bwd` in plain torch ops (the attention recomputed
    by `fused_attention_qkv`, the projection and LN2 chain with fp32
    operands, d(qkv) from `fused_attention_qkv_bwd`)."""

    @staticmethod
    def forward(ctx, qkv, res, w, b, ln_s, ln_b, num_heads, scale, eps):
        x2, y2 = attention_block(qkv, res, w, b, ln_s, ln_b, num_heads, scale, eps)
        ctx.save_for_backward(qkv, res, w, ln_s, x2)
        ctx.cfg = (num_heads, scale, eps)
        return x2, y2

    @staticmethod
    def backward(ctx, gx2, gy2):
        qkv, res, w, ln_s, x2 = ctx.saved_tensors
        num_heads, scale, eps = ctx.cfg
        R, N, C = x2.shape
        ds, dln_s, dln_b = ln_bwd_rows(x2.reshape(R * N, C).float(), ln_s,
                                       gy2.reshape(R * N, C), eps)
        if gx2 is not None:
            ds = ds + gx2.reshape(R * N, C).float()
        # x2 = res + (a @ w + b)
        dres = ds.to(res.dtype).reshape(R, N, C)
        a = fused_attention_qkv(qkv, num_heads, scale)
        dw = torch.matmul(a.reshape(R * N, C).float().t(), ds).to(w.dtype)
        db = ds.sum(dim=0).to(w.dtype)
        da = torch.matmul(ds, w.float().t()).to(qkv.dtype).reshape(R, N, C)
        dqkv = fused_attention_qkv_bwd(qkv, da, num_heads, scale)
        return (dqkv, dres, dw, db, dln_s.to(ln_s.dtype), dln_b.to(ln_s.dtype),
                None, None, None)


def attention_block_ad(qkv, res, w, b, ln_s, ln_b, num_heads, scale, eps):
    """Differentiable `attention_block` (the JAX `attention_block_p`)."""
    return _AttentionBlock.apply(qkv, res, w, b, ln_s, ln_b, num_heads, scale, eps)


class _AttentionBlockPartial(torch.autograd.Function):
    """Forward: `attention_block_partial` (K6-tp); backward: the block
    Function's projection and attention-core backward on the rank's heads
    (fp32 operands for the projection, d(qkv) from
    `fused_attention_qkv_bwd`)."""

    @staticmethod
    def forward(ctx, qkv, wp, num_heads, scale):
        ctx.save_for_backward(qkv, wp)
        ctx.cfg = (num_heads, scale)
        return attention_block_partial(qkv, wp, num_heads, scale)

    @staticmethod
    def backward(ctx, gpart):
        qkv, wp = ctx.saved_tensors
        num_heads, scale = ctx.cfg
        R, N, c3 = qkv.shape
        ds = gpart.reshape(R * N, -1).float()
        a = fused_attention_qkv(qkv, num_heads, scale)
        dw = torch.matmul(a.reshape(R * N, c3 // 3).float().t(), ds).to(wp.dtype)
        da = torch.matmul(ds, wp.float().t()).to(qkv.dtype).reshape(R, N, c3 // 3)
        return fused_attention_qkv_bwd(qkv, da, num_heads, scale), dw, None, None


def attention_block_partial_ad(qkv, wp, num_heads, scale):
    """Differentiable `attention_block_partial` (K6-tp)."""
    return _AttentionBlockPartial.apply(qkv, wp, num_heads, scale)


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

"""The depth-resident MixSTE trunk: all 2 x depth blocks of the eval forward
in one kernel launch (fuse level 5).

`resident_block_stack` is the counterpart of the JAX package's
`resident_block_stack` (`d3dp_tpu/ops/resident.py`), with its signature:
the (B, F, J, C) embedded stream, the temporal position embedding (F, C),
each kind's depth-stacked weights and the shared norms in, the stream after
the trunk (before the head norm) out. It computes what the level-4 flow
computes: per depth the spatial pair (`attention.attention_stage`, then
`mlp.mlp_block_t` with the shared spatial norm), the temporal position
embedding after the first spatial pair, then the temporal pair.

On a CUDA tensor it launches the hand-written kernel (`csrc/resident.cu`),
one cooperative launch whose blocks walk the trunk's phases with grid
barriers between them, on groups of rows large enough that every GEMM phase
(ln_qkv, proj_ln2, the MLP) has several waves of 64-row tiles on the SMs
the device reports (`group_rows`): a group of one row gives each phase at
most one tile a block, so each phase costs a tile's latency and a grid
barrier, with half the SMs idle in the MLP. The group's stream and scratch
go through device memory, about 2.5 GB a stage at the eval shape (12 ms a
forward at 3.35 TB/s), below the time of the products.
`resident_phase_clocks` runs the kernel once from a build that sums each
phase's cycles in its tiles and at its barrier, the measure of what the
barriers cost. On a CPU tensor it runs
`resident_block_stack_plain`, the loop over depths of the level-4 ops'
plain versions. There is no fallback between the two: a CUDA input the
kernel does not take raises.

The lab switches the JAX kernel reads reach the same tile functions as at
level 4: `D3DP_SOFTMAX_FOLD` other than 1 (bf16) and the global
`D3DP_ATTN_VARIANT=bf16exp` (bf16; the per-stage `_T`/`_S` variables do
not reach this kernel, as in JAX) as the stage's OPT_* flags, and
`D3DP_MLP_VARIANT` as the MLP's activation (`resident_options`).

The JAX kernel's tile knobs `D3DP_RES_SP_TOKENS`, `D3DP_RES_TP_SEQS` and
`D3DP_RES_UNROLL` choose the chunks of a row that Mosaic keeps in the TPU's
VMEM; they have no meaning on Hopper and are not ported.
"""

import ctypes

import torch

from d3dp_tpu_torch.ops import _build, tf32
from d3dp_tpu_torch.ops.attention import (HEAD_DIM, MAX_TOKENS, OPT_BF16_EXP,
                                          attention_stage_plain, fold_opts, stage_variant)
from d3dp_tpu_torch.ops.mlp import (GELU_ERF, check_shape as check_mlp_shape, gelu_mode,
                                    mlp_block_t_plain)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_N_PTRS = 23
_SIG = [ctypes.POINTER(ctypes.c_void_p)] + [_I] * 10 + [_F, _F, _P]
_FN = {torch.bfloat16: "d3dp_resident_bf16", torch.float32: "d3dp_resident_f32"}
_ERRORS = {-1: "the device has no cooperative launch",
           -2: "the kernel's shared memory fits no block on an SM"}
# the token rows of a GEMM phase's tile, and the waves of them a group gives
# the SMs
TILE_ROWS = 64
WAVES = 16
# the phases the clocks build times, in the kernel's order
PHASES = ("spatial ln_qkv", "spatial attend", "spatial proj_ln2", "spatial mlp", "tpos add",
          "temporal ln_qkv", "temporal attend", "temporal proj_ln2", "temporal mlp")


def group_rows(B, F, J, sms):
    """Rows the kernel takes at a time: enough that each GEMM phase has
    WAVES waves of TILE_ROWS-row tiles on `sms` SMs, at most B, with the
    groups as even as their count allows."""
    G = max(1, min(B, -(-WAVES * sms * TILE_ROWS // (F * J))))
    n = -(-B // G)
    return -(-B // n)


def _kind(weights, d):
    """Depth d of one kind's stacked weights, in the level-4 ops' argument
    order: wqkv, bqkv, wp, bp, ln1s, ln1b, ln2s, ln2b, then the MLP's w1,
    b1, w2, b2."""
    wqkv, bqkv, wp, w1, b1, w2, vec = weights
    bp, ln1s, ln1b, ln2s, ln2b, b2 = vec[d].unbind(0)
    return ((wqkv[d], bqkv[d].reshape(-1), wp[d], bp, ln1s, ln1b, ln2s, ln2b),
            (w1[d], b1[d].reshape(-1), w2[d], b2))


def _with_planes(weights, planes):
    """One kind's seven weights with its four matrices replaced by their
    planes (wqkv, wp, w1, w2)."""
    wqkv, bqkv, wp, w1, b1, w2, vec = weights
    pq, pp, p1, p2 = planes
    return (pq, bqkv, pp, p1, b1, p2, vec)


def resident_options(dtype):
    """(opts, gelu) of the lab switches the JAX kernel reads for the
    compute dtype: the stage's OPT_* flags (`D3DP_SOFTMAX_FOLD`, the global
    `D3DP_ATTN_VARIANT=bf16exp`) and the MLP's GELU_* activation."""
    opts = fold_opts(dtype)
    if dtype == torch.bfloat16 and stage_variant() == "bf16exp":
        opts |= OPT_BF16_EXP
    return opts, gelu_mode(dtype)


def resident_block_stack_plain(x, tpos, spatial, temporal, shared, num_heads, scale, eps,
                               opts=0, gelu=GELU_ERF):
    """Plain torch ops: the loop over depths of `attention_stage_plain` and
    `mlp_block_t_plain` (the level-4 flow) with the lab switches opts and
    gelu (`resident_options`), the compute-dtype tpos add after the first
    spatial pair."""
    B, F, J, C = x.shape
    h = x
    for d in range(spatial[0].shape[0]):
        stage, mlp = _kind(spatial, d)
        x2, y2 = attention_stage_plain(h.reshape(B * F, J, C), *stage, num_heads, scale, eps,
                                       opts=opts)
        h = mlp_block_t_plain(y2.view(B, F, J, C), x2.view(B, F, J, C), *mlp,
                              shared[0], shared[1], eps, gelu=gelu)  # (B, J, F, C)
        if d == 0:
            h = h + tpos.to(x.dtype)
        stage, mlp = _kind(temporal, d)
        x2, y2 = attention_stage_plain(h.reshape(B * J, F, C), *stage, num_heads, scale, eps,
                                       opts=opts)
        h = mlp_block_t_plain(y2.view(B, J, F, C), x2.view(B, J, F, C), *mlp,
                              shared[2], shared[3], eps, gelu=gelu)  # (B, F, J, C)
    return h


def resident_block_stack(x, tpos, spatial, temporal, shared, num_heads, scale, eps,
                         planes=None):
    """The (B, F, J, C) stream after the trunk; see the module docstring.

    x: (B, F, J, C) in the compute dtype; tpos: (F, C); spatial, temporal:
    (wqkv (D, C, 3C), bqkv (D, 1, 3C), wp (D, C, C), w1 (D, C, H),
    b1 (D, 1, H), w2 (D, H, C), vec (D, 6, C)), matrices in the compute
    dtype, bqkv, b1 and vec (rows bp, ln1s, ln1b, ln2s, ln2b, b2) fp32;
    shared: (4, C) fp32 rows spatial norm scale, bias, temporal norm
    scale, bias. The lab switches as `resident_options` reads them. fp32
    runs on each matrix stack's TF32 planes ((D, 2, 3C, C), (D, 2, C, C),
    (D, 2, H, C), (D, 2, C, H)): `planes`, (spatial, temporal) of those
    four each (the model's weight cache makes them once per weight
    version), else made here (`ops.tf32.operands`)."""
    opts, gelu = resident_options(x.dtype)
    if x.device.type == "cpu":
        return resident_block_stack_plain(x, tpos, spatial, temporal, shared, num_heads,
                                          scale, eps, opts=opts, gelu=gelu)
    out = _launch(x, tpos, spatial, temporal, shared, num_heads, scale, eps, opts, gelu,
                  planes=planes)
    resident_block_stack.launches += 1
    return out


resident_block_stack.launches = 0


def resident_phase_clocks(x, tpos, spatial, temporal, shared, num_heads, scale, eps,
                          group=None):
    """Run the kernel once on CUDA operands of `resident_block_stack` from
    the build with per-phase clocks (-DD3DP_PHASE_CLOCKS) and return
    {phase: (cycles in its tiles, cycles at the grid barrier after them)}
    for each of PHASES, SM cycles of thread 0 of each block summed over the
    blocks (one an SM), row groups and depths; group: the rows a group, in
    place of `group_rows`'. Not a model path: a measurement of where K9's
    time goes."""
    opts, gelu = resident_options(x.dtype)
    lib = _launch(x, tpos, spatial, temporal, shared, num_heads, scale, eps, opts, gelu,
                  clocks=True, group=group)[1]
    torch.cuda.synchronize(x.device)
    sums = (ctypes.c_ulonglong * (2 * len(PHASES)))()
    _build.check(lib.d3dp_resident_phase_clocks(sums), "resident_phase_clocks")
    return {p: (sums[2 * i], sums[2 * i + 1]) for i, p in enumerate(PHASES)}


def _launch(x, tpos, spatial, temporal, shared, num_heads, scale, eps, opts, gelu, clocks=False,
            group=None, planes=None):
    """Check the operands and launch the kernel on groups of `group` rows (by
    default `group_rows`'); with clocks, from the build with per-phase
    clocks, returning (out, that library); planes: `resident_block_stack`'s."""
    if x.device.type != "cuda":
        raise ValueError(f"resident_block_stack: unsupported device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"x must be (B, F, J, C), got {tuple(x.shape)}")
    B, F, J, C = x.shape
    dt = x.dtype
    if dt not in _FN:
        raise ValueError(f"resident_block_stack: unsupported dtype {dt}")
    if C != num_heads * HEAD_DIM or C % 64 or C > 1024:
        raise ValueError(f"resident_block_stack: needs head_dim {HEAD_DIM} and C % 64 == 0, "
                         f"C <= 1024 (C={C}, heads={num_heads})")
    for n, what in ((F, "F"), (J, "J")):
        if not 1 <= n <= MAX_TOKENS:
            raise ValueError(f"resident_block_stack: {what}={n} outside 1..{MAX_TOKENS}")
    D, H = spatial[0].shape[0], spatial[3].shape[-1]
    if D < 1:
        raise ValueError(f"resident_block_stack: needs depth >= 1 (D={D})")
    check_mlp_shape("resident_block_stack", C, H, dt)
    dev = x.device
    f32 = torch.float32
    tpos = tpos.to(dt).contiguous()
    _build.check_operand(x, "x", dt, (B, F, J, C), dev)
    _build.check_operand(tpos, "tpos", dt, (F, C), dev)
    _build.check_operand(shared, "shared", f32, (4, C), dev)
    for kind, ws in (("spatial", spatial), ("temporal", temporal)):
        for t, name, dtype, shape in zip(
                ws, ("wqkv", "bqkv", "wp", "w1", "b1", "w2", "vec"),
                (dt, f32, dt, dt, f32, dt, f32),
                ((D, C, 3 * C), (D, 1, 3 * C), (D, C, C), (D, C, H), (D, 1, H), (D, H, C),
                 (D, 6, C))):
            _build.check_operand(t, f"{kind} {name}", dtype, shape, dev)
    if dt == f32:
        # the kernel takes each matrix's planes in its place
        spatial, temporal = (
            _with_planes(ws, tf32.operands((ws[0], ws[2], ws[3], ws[5]),
                                           [f"{kind} {n}" for n in ("wqkv", "wp", "w1", "w2")],
                                           dev, given))
            for kind, ws, given in (("spatial", spatial, planes and planes[0]),
                                    ("temporal", temporal, planes and planes[1])))
    sigs = {fn: _SIG for fn in _FN.values()}
    if clocks:
        lib = _build.load("resident_clocks", {**sigs, "d3dp_resident_phase_clocks": [_P]})
    else:
        lib = _build.load("resident", sigs)
    G = group or group_rows(B, F, J, torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        out = torch.empty_like(x)
        qkv = torch.empty((G * F * J, 3 * C), dtype=dt, device=dev)
        o, x2, y2, tbuf = (torch.empty((G * F * J, C), dtype=dt, device=dev) for _ in range(4))
        tensors = [x, tpos, *spatial, *temporal, shared, out, qkv, o, x2, y2, tbuf]
        ptrs = (ctypes.c_void_p * _N_PTRS)(*(t.data_ptr() for t in tensors))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, _FN[dt])(ptrs, B, F, J, C, H, D, num_heads, G, opts, gelu,
                                    float(scale), float(eps), stream)
    if err in _ERRORS:
        raise RuntimeError(f"resident_block_stack: {_ERRORS[err]}")
    _build.check(err, "resident_block_stack")
    return (out, lib) if clocks else out

"""Hand-written CUDA kernels against their plain torch versions, on the
card. Skipped without a CUDA device. This file imports neither JAX nor the
JAX package, so it runs on a machine that has only torch:

    python -m pytest tests/test_torch_kernels.py -q --noconftest

(`--noconftest`: tests/conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.ops import mlp as tmlp


def _stage_inputs(rng, R, N, C, w_scale=0.1):
    x = rng.randn(R, N, C).astype(np.float32)
    return [x,
            (rng.randn(C, 3 * C) * w_scale).astype(np.float32),
            (rng.randn(3 * C) * 0.05).astype(np.float32),
            (rng.randn(C, C) * w_scale).astype(np.float32),
            (rng.randn(C) * 0.05).astype(np.float32),
            (1 + 0.1 * rng.randn(C)).astype(np.float32),
            (0.1 * rng.randn(C)).astype(np.float32),
            (1 + 0.1 * rng.randn(C)).astype(np.float32),
            (0.1 * rng.randn(C)).astype(np.float32)]


def _mlp_inputs(rng, B0, D1, D2, C, H):
    return [rng.randn(B0, D1, D2, C).astype(np.float32),
            rng.randn(B0, D1, D2, C).astype(np.float32),
            (rng.randn(C, H) * 0.05).astype(np.float32),
            (rng.randn(H) * 0.01).astype(np.float32),
            (rng.randn(H, C) * 0.05).astype(np.float32),
            (rng.randn(C) * 0.01).astype(np.float32),
            (rng.rand(C) + 0.5).astype(np.float32),
            (rng.randn(C) * 0.1).astype(np.float32)]


def _t(arrs, device="cpu", dtype=None):
    out = [torch.from_numpy(a).to(device) for a in arrs]
    return [o.to(dtype) if dtype is not None and o.dim() > 1 else o for o in out]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    from d3dp_tpu_torch import disable_tf32
    disable_tf32()
    return torch.device("cuda")


@pytest.fixture
def np_rng():
    return np.random.RandomState(0)


# fp32: summation order only. bf16: roundings fall at other places than in
# the plain version (different accumulation order before each rounding), so
# an output may sit one bf16 ulp away: 3e-2 on unit-scale values plus one
# ulp of the value's own magnitude (2^-7 relative at most).
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (3e-2, 2.0 ** -7)}


# the attention core and its backward: unit-normal qkv at scale 1/8 gives
# outputs and gradients of about 0.1, so the bf16 absolute term is 1e-2,
# which a dropped or doubled 16-key tile would exceed
TOL_QKV = {torch.float32: (1e-4, 0.0), torch.bfloat16: (1e-2, 2.0 ** -7)}


def _excess(got, want, dtype, tol=TOL):
    atol, rel = tol[dtype]
    d = (got.float() - want.float()).abs()
    return (d - atol - rel * want.float().abs()).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N", [(64, 17), (6, 243), (5, 100), (4, 129), (3, 1), (2, 256)])
def test_attention_stage_kernel_matches_plain(np_rng, dtype, R, N):
    dev = _cuda()
    # weights of std 0.05 keep x2 at the main path's scale (|x2| < 8), where
    # one bf16 ulp stays inside the tolerance
    args = _t(_stage_inputs(np_rng, R, N, 512, w_scale=0.05), dev, dtype)
    args[0] = args[0] * 0.5
    n0 = tattn.attention_stage.launches
    got = tattn.attention_stage(*args, 8, 0.125, 1e-6)
    want = tattn.attention_stage_plain(*args, 8, 0.125, 1e-6)
    torch.cuda.synchronize()
    assert tattn.attention_stage.launches == n0 + 1
    for g, w in zip(got, want):
        assert _excess(g, w, dtype) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 243, 17), (3, 17, 243)])
def test_mlp_block_t_kernel_matches_plain(np_rng, dtype, shape):
    dev = _cuda()
    args = _t(_mlp_inputs(np_rng, *shape, 512, 1024), dev, dtype)
    n0 = tmlp.mlp_block_t.launches
    got = tmlp.mlp_block_t(*args, 1e-6)
    want = tmlp.mlp_block_t_plain(*args, 1e-6)
    torch.cuda.synchronize()
    assert tmlp.mlp_block_t.launches == n0 + 1
    assert _excess(got, want, dtype) <= 0


QKV_SHAPES = [(16, 17), (4, 243), (3, 1), (2, 256), (5, 100), (4, 129)]
# the attention tile's edges: the shared-memory body ends at 32 keys; the
# tensor-core tile's key fragments (64, 128, 256 keys) and its passes of 128
# queries
TILE_EDGE_SHAPES = [(5, 32), (5, 33), (4, 64), (4, 65), (3, 192), (3, 255)]


def _qkv_inputs(rng, R, N, dev, dtype, C=512):
    qkv = torch.from_numpy(rng.randn(R, N, 3 * C).astype(np.float32)).to(dev, dtype)
    dout = torch.from_numpy(rng.randn(R, N, C).astype(np.float32)).to(dev, dtype)
    return qkv, dout


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N", QKV_SHAPES + TILE_EDGE_SHAPES)
def test_fused_attention_qkv_kernel_matches_plain(np_rng, dtype, R, N):
    dev = _cuda()
    qkv, _ = _qkv_inputs(np_rng, R, N, dev, dtype)
    n0 = tattn.fused_attention_qkv.launches
    got = tattn.fused_attention_qkv(qkv, 8, 0.125)
    want = tattn.fused_attention_qkv_plain(qkv, 8, 0.125)
    torch.cuda.synchronize()
    assert tattn.fused_attention_qkv.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (R, N, 512)
    assert _excess(got, want, dtype, TOL_QKV) <= 0


# the backward's own tiles: a warp a tile at 16 and 32 keys, a block a tile
# of 64, 128 or 256 keys above
BWD_EDGE_SHAPES = [(6, 16), (4, 48), (4, 63), (3, 64), (3, 128), (3, 129)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N", QKV_SHAPES + TILE_EDGE_SHAPES + BWD_EDGE_SHAPES)
def test_fused_attention_qkv_bwd_kernel_matches_plain(np_rng, dtype, R, N):
    dev = _cuda()
    qkv, dout = _qkv_inputs(np_rng, R, N, dev, dtype)
    n0 = tattn.fused_attention_qkv_bwd.launches
    got = tattn.fused_attention_qkv_bwd(qkv, dout, 8, 0.125)
    want = tattn.fused_attention_qkv_bwd_plain(qkv, dout, 8, 0.125)
    torch.cuda.synchronize()
    assert tattn.fused_attention_qkv_bwd.launches == n0 + 1
    assert got.dtype == dtype and got.shape == qkv.shape
    assert _excess(got, want, dtype, TOL_QKV) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("N", [17, 243])
def test_fused_attention_qkv_bwd_is_deterministic(np_rng, N):
    """bf16: two calls give the same bits, and a sequence's d(qkv) does not
    depend on the other sequences of the batch (R = 1 against R = 5)."""
    dev = _cuda()
    qkv, dout = _qkv_inputs(np_rng, 5, N, dev, torch.bfloat16)
    a = tattn.fused_attention_qkv_bwd(qkv, dout, 8, 0.125)
    b = tattn.fused_attention_qkv_bwd(qkv, dout, 8, 0.125)
    one = tattn.fused_attention_qkv_bwd(qkv[2:3].contiguous(), dout[2:3].contiguous(), 8, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(one[0], a[2])


@pytest.mark.gpu
@pytest.mark.parametrize("R,N", [(16, 17), (4, 243)])
def test_fused_attention_qkv_bwd_kernel_matches_autograd_of_plain(np_rng, R, N):
    """fp32: the backward kernel against torch.autograd through the plain
    forward (summation order only)."""
    dev = _cuda()
    qkv, dout = _qkv_inputs(np_rng, R, N, dev, torch.float32)
    qkv.requires_grad_(True)
    (want,) = torch.autograd.grad(tattn.fused_attention_qkv_plain(qkv, 8, 0.125), qkv, dout)
    got = tattn.fused_attention_qkv_bwd(qkv.detach(), dout, 8, 0.125)
    torch.cuda.synchronize()
    assert _excess(got, want, torch.float32, TOL_QKV) <= 0


KERNEL_NS = [1, 17, 100, 129, 243, 256]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", KERNEL_NS)
def test_mlp_block_kernel_matches_plain(np_rng, dtype, N):
    """(R, C) rows with R = 3 * N: a partial last row block at every N but
    256 (32 bf16 or 16 fp32 rows per block)."""
    dev = _cuda()
    args = _t(_mlp_inputs(np_rng, 1, 3 * N, 1, 512, 1024), dev, dtype)
    args[:2] = [a.view(3 * N, 512) for a in args[:2]]
    n0 = tmlp.mlp_block.launches
    got = tmlp.mlp_block(*args, 1e-6)
    want = tmlp.mlp_block_plain(*args, 1e-6)
    torch.cuda.synchronize()
    assert tmlp.mlp_block.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (3 * N, 512)
    assert _excess(got, want, dtype) <= 0


def _block_inputs(rng, R, N, dev, dtype, C=512):
    """qkv at unit scale, a residual of 0.5 and a 0.05 projection keep x2 at
    the main path's scale, where one bf16 ulp stays inside the tolerance."""
    arrs = [rng.randn(R, N, 3 * C), rng.randn(R, N, C) * 0.5, rng.randn(C, C) * 0.05,
            rng.randn(C) * 0.02, 1 + 0.1 * rng.randn(C), 0.1 * rng.randn(C)]
    return _t([a.astype(np.float32) for a in arrs], dev, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", KERNEL_NS)
def test_attention_block_kernel_matches_plain(np_rng, dtype, N):
    dev = _cuda()
    R = 5 if N > 100 else 19  # the proj/LN2 launch's 32-row blocks end partial
    args = _block_inputs(np_rng, R, N, dev, dtype)
    n0 = tattn.attention_block.launches
    got = tattn.attention_block(*args, 8, 0.125, 1e-6)
    want = tattn.attention_block_plain(*args, 8, 0.125, 1e-6)
    torch.cuda.synchronize()
    assert tattn.attention_block.launches == n0 + 1
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (R, N, 512)
        assert _excess(g, w, dtype) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", KERNEL_NS + [n for _, n in TILE_EDGE_SHAPES])
def test_fused_attention_packed_kernel_matches_plain(np_rng, dtype, N):
    dev = _cuda()
    R = 3 if N > 100 else 7
    q, k, v = (torch.from_numpy(np_rng.randn(R, N, 512).astype(np.float32)).to(dev, dtype)
               for _ in range(3))
    n0 = tattn.fused_attention_packed.launches
    got = tattn.fused_attention_packed(q, k, v, 8, 0.125)
    want = tattn.fused_attention_plain(q, k, v, 8, 0.125)
    torch.cuda.synchronize()
    assert tattn.fused_attention_packed.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (R, N, 512)
    assert _excess(got, want, dtype, TOL_QKV) <= 0
    # the (B, N, h, d) wrapper launches the same kernel
    shaped = tattn.fused_attention(*(t.view(R, N, 8, 64) for t in (q, k, v)), 0.125)
    assert torch.equal(shaped.reshape(R, N, 512), got)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", [0, tattn.OPT_NORM_FIRST, tattn.OPT_BF16_EXP])
@pytest.mark.parametrize("R,N", [(16, 17), (4, 243)] + TILE_EDGE_SHAPES)
def test_attend_qkv_kernel_matches_plain(np_rng, dtype, opts, R, N):
    """The stage's attend launch alone against its plain version (TOL_QKV),
    with each switch that reaches the tile; with p / l first it is K3's
    launch, equal to K3 bit for bit."""
    dev = _cuda()
    qkv, _ = _qkv_inputs(np_rng, R, N, dev, dtype)
    n0 = tattn.attend_qkv.launches
    got = tattn.attend_qkv(qkv, 8, 0.125, opts)
    want = tattn.attend_qkv_plain(qkv, 8, 0.125, opts)
    torch.cuda.synchronize()
    assert tattn.attend_qkv.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (R, N, 512)
    assert _excess(got, want, dtype, TOL_QKV) <= 0
    if opts == tattn.OPT_NORM_FIRST:
        assert torch.equal(got, tattn.fused_attention_qkv(qkv, 8, 0.125))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["attend", "qkv", "packed"])
@pytest.mark.parametrize("N", [17, 243])
def test_attention_rows_do_not_depend_on_the_batch(np_rng, dtype, op, N):
    """A sequence's attention output is the same bit for bit computed alone
    and inside batches of 7 and 680 sequences: each row's arithmetic does
    not depend on R or the tile walk (what level 5 = level 4 rests on)."""
    dev = _cuda()
    qkv = torch.from_numpy(np_rng.randn(680, N, 1536).astype(np.float32)).to(dev, dtype)
    if op == "packed":
        q, k, v = (t.contiguous() for t in qkv.split(512, dim=-1))
        run = lambda a, b: tattn.fused_attention_packed(q[a:b], k[a:b], v[a:b], 8, 0.125)  # noqa
    else:
        f = tattn.attend_qkv if op == "attend" else tattn.fused_attention_qkv
        run = lambda a, b: f(qkv[a:b], 8, 0.125)  # noqa: E731
    full, seven = run(0, 680), run(0, 7)
    for i in (0, 3, 6):
        alone = run(i, i + 1)
        assert torch.equal(alone[0], seven[i]) and torch.equal(alone[0], full[i])
    assert torch.equal(seven, full[:7])


@pytest.mark.gpu
def test_wrappers_raise_on_what_the_kernels_do_not_take(np_rng):
    """A CUDA input the kernel does not take raises; nothing falls back to
    the plain version."""
    dev = _cuda()
    args = _t(_stage_inputs(np_rng, 2, 17, 512), dev, torch.float32)
    with pytest.raises(ValueError, match="N=300"):
        tattn.attention_stage(torch.zeros(1, 300, 512, device=dev), *args[1:], 8, 0.125, 1e-6)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.attention_stage(*args, 4, 0.125, 1e-6)
    with pytest.raises(ValueError, match="dtype"):
        tattn.attention_stage(args[0].half(), *args[1:], 8, 0.125, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        tattn.attention_stage(args[0].transpose(0, 1).contiguous().transpose(0, 1),
                              *args[1:], 8, 0.125, 1e-6)
    margs = _t(_mlp_inputs(np_rng, 2, 9, 17, 512, 1024), dev, torch.bfloat16)
    with pytest.raises(ValueError, match="w1 has dtype"):
        tmlp.mlp_block_t(*margs[:2], margs[2].float(), *margs[3:], 1e-6)
    qkv, dout = _qkv_inputs(np_rng, 2, 17, dev, torch.bfloat16)
    with pytest.raises(ValueError, match="N=300"):
        tattn.fused_attention_qkv(torch.zeros(1, 300, 1536, device=dev), 8, 0.125)
    with pytest.raises(ValueError, match="head_dim"):
        tattn.fused_attention_qkv(qkv, 4, 0.125)
    with pytest.raises(ValueError, match="dtype"):
        tattn.fused_attention_qkv(qkv.half(), 8, 0.125)
    with pytest.raises(ValueError, match="dout has dtype"):
        tattn.fused_attention_qkv_bwd(qkv, dout.float(), 8, 0.125)
    with pytest.raises(ValueError, match="contiguous"):
        tattn.fused_attention_qkv_bwd(qkv, dout.transpose(0, 1).contiguous().transpose(0, 1),
                                      8, 0.125)
    with pytest.raises(ValueError, match="x must be"):
        tmlp.mlp_block(*margs, 1e-6)
    with pytest.raises(ValueError, match="res has shape"):
        tmlp.mlp_block(margs[0].view(-1, 512), margs[1].view(-1, 512)[1:], *margs[2:], 1e-6)
    bargs = _block_inputs(np_rng, 2, 17, dev, torch.bfloat16)
    with pytest.raises(ValueError, match="qkv has shape"):
        tattn.attention_block(bargs[0][:, :, :512].contiguous(), *bargs[1:], 8, 0.125, 1e-6)
    with pytest.raises(ValueError, match="N=300"):
        tattn.attention_block(torch.zeros(1, 300, 1536, device=dev, dtype=torch.bfloat16),
                              torch.zeros(1, 300, 512, device=dev, dtype=torch.bfloat16),
                              *bargs[2:], 8, 0.125, 1e-6)
    with pytest.raises(ValueError, match="k has dtype"):
        tattn.fused_attention_packed(dout, dout.float(), dout, 8, 0.125)


def _resident_inputs(rng, B, F, dev, dtype, J=17, C=512, H=1024, D=2):
    """K9's operands at the published width: a unit-scale stream, weights
    of std 0.05 (matrices in the compute dtype), LN scales near 1."""
    def kind():
        vec = 0.05 * rng.randn(D, 6, C)
        vec[:, [1, 3]] += 1.0
        mats = [rng.randn(D, C, 3 * C), rng.randn(D, C, C), rng.randn(D, C, H),
                rng.randn(D, H, C)]
        wqkv, wp, w1, w2 = (torch.from_numpy((0.05 * m).astype(np.float32)).to(dev, dtype)
                            for m in mats)
        bqkv, b1, vec = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            0.02 * rng.randn(D, 1, 3 * C), 0.02 * rng.randn(D, 1, H), vec))
        return wqkv, bqkv, wp, w1, b1, w2, vec
    x = torch.from_numpy(rng.randn(B, F, J, C).astype(np.float32)).to(dev, dtype)
    tpos = torch.from_numpy((0.1 * rng.randn(F, C)).astype(np.float32)).to(dev)
    shared = torch.from_numpy((0.05 * rng.randn(4, C) + np.array([1.0, 0, 1.0, 0])[:, None])
                              .astype(np.float32)).to(dev)
    return x, tpos, kind(), kind(), shared


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,F", [(2, 243), (15, 27)])
def test_resident_kernel_matches_plain(np_rng, dtype, B, F):
    """K9 at C=512: 2 rows of 243 frames (one row per group), and 15 rows of
    27 frames (13 rows a group: a partial last group). fp32 at depth 2:
    TOL. bf16: TOL at depth 1 (one block pair, as K1/K2); at depth 2 the
    rounding flips of the chained blocks compound on both sides, so the
    kernel is held to be no further than 1.05x the plain version from the
    fp32 math of the same bf16 inputs (relative L2)."""
    from d3dp_tpu_torch.ops import resident as tres

    dev = _cuda()
    x, tpos, sp, tp, shared = _resident_inputs(np_rng, B, F, dev, dtype)
    for D in (1, 2):
        args = (x, tpos, tuple(w[:D] for w in sp), tuple(w[:D] for w in tp), shared)
        n0 = tres.resident_block_stack.launches
        got = tres.resident_block_stack(*args, 8, 0.125, 1e-6)
        want = tres.resident_block_stack_plain(*args, 8, 0.125, 1e-6)
        torch.cuda.synchronize()
        assert tres.resident_block_stack.launches == n0 + 1
        assert got.dtype == dtype and got.shape == (B, F, 17, 512)
        if dtype == torch.float32 or D == 1:
            assert _excess(got, want, dtype) <= 0
        else:
            ref = tres.resident_block_stack_plain(
                x.float(), tpos, tuple(w[:D].float() for w in sp),
                tuple(w[:D].float() for w in tp), shared, 8, 0.125, 1e-6)
            rel_k = (got.float() - ref).norm() / ref.norm()
            rel_p = (want.float() - ref).norm() / ref.norm()
            assert rel_k <= 1.05 * rel_p


def _model(dtype, depth=2, level=5, frames=243):
    from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig

    m = MixSTE2(MixSTEConfig(num_frames=frames, depth=depth, dtype=dtype, fuse_level=level),
                seed=5)
    g = torch.Generator(device="cuda").manual_seed(6)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn(p.shape, generator=g, device="cuda") * 0.02)
    return m


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("F", [243, 100, 48])
def test_level_5_launches_k9_once_and_equals_level_4(np_rng, dtype, F):
    """One K9 launch per forward at level 5 and no K1/K2; the output equals
    level 4's bit for bit (same roundings; in bf16 at F > 32 K9 computes S
    in parts where K1 keeps it whole: 16, 8 and 4 key fragments)."""
    import dataclasses

    from d3dp_tpu_torch.ops import resident as tres

    dev = _cuda()
    model = _model(dtype, frames=F)
    x2d = torch.from_numpy(np_rng.randn(2, F, 17, 2).astype(np.float32) * 0.3).to(dev)
    x3d = torch.from_numpy(np_rng.randn(2, F, 17, 3).astype(np.float32)).to(dev)
    t = torch.tensor([999, 17], device=dev)
    ops = (tres.resident_block_stack, tattn.attention_stage, tmlp.mlp_block_t)
    n0 = [f.launches for f in ops]
    out5 = model(x2d, x3d, t)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(ops, n0)] == [1, 0, 0]
    model.cfg = dataclasses.replace(model.cfg, fuse_level=4)
    out4 = model(x2d, x3d, t)
    assert torch.equal(out5, out4)


@pytest.mark.gpu
def test_reuse_sample_launch_counts():
    """Level 5 with reuse interval 2, tap 2, K=5, depth 8: steps 0, 2 and 4
    run all 8 pairs, steps 1 and 3 the first 2, all on level 4's flow:
    3 * 16 + 2 * 4 = 56 K1 and 56 K2, no K9."""
    from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
    from d3dp_tpu_torch.ops import resident as tres

    dev = _cuda()
    model = _model(torch.bfloat16, depth=8)
    d3dp = D3DP(D3DPConfig(model=model.cfg, num_proposals=1, sampling_timesteps=5,
                           reuse_interval=2, reuse_tap=2), model=model)
    g = torch.Generator(device=dev).manual_seed(0)
    x2d = torch.randn(1, 243, 17, 2, generator=g, device=dev) * 0.3
    ops = (tattn.attention_stage, tmlp.mlp_block_t, tres.resident_block_stack)
    n0 = [f.launches for f in ops]
    out = d3dp.sample(x2d, x2d.flip(2), generator=g)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(ops, n0)] == [56, 56, 0]
    assert torch.isfinite(out).all()


@pytest.mark.gpu
def test_resident_raises_on_what_the_kernel_does_not_take(np_rng):
    from d3dp_tpu_torch.ops import resident as tres

    dev = _cuda()
    x, tpos, sp, tp, shared = _resident_inputs(np_rng, 1, 27, dev, torch.bfloat16, D=1)
    with pytest.raises(ValueError, match="head_dim"):
        tres.resident_block_stack(x, tpos, sp, tp, shared, 4, 0.125, 1e-6)
    with pytest.raises(ValueError, match="dtype"):
        tres.resident_block_stack(x.half(), tpos, sp, tp, shared, 8, 0.125, 1e-6)
    with pytest.raises(ValueError, match="F=300"):
        tres.resident_block_stack(torch.zeros(1, 300, 17, 512, device=dev, dtype=torch.bfloat16),
                                  tpos, sp, tp, shared, 8, 0.125, 1e-6)
    with pytest.raises(ValueError, match="spatial w1 has dtype"):
        tres.resident_block_stack(x, tpos, (*sp[:3], sp[3].float(), *sp[4:]), tp, shared, 8,
                                  0.125, 1e-6)
    with pytest.raises(ValueError, match="temporal vec has shape"):
        tres.resident_block_stack(x, tpos, sp, (*tp[:6], tp[6][:, :5].contiguous()), shared, 8,
                                  0.125, 1e-6)


# ------------------------------------- DropPath forms (K1-dp, K2-dp, K5-dp)
def _dp_scales(rng, shape, dev, keep=0.9):
    """0 where dropped, 1/keep where kept, at least one of each."""
    m = np.where(rng.rand(*shape) < keep, 1.0 / keep, 0.0).astype(np.float32)
    m.flat[0], m.flat[-1] = 0.0, 1.0 / keep
    return torch.from_numpy(m).to(dev)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N", [(64, 17), (6, 243), (5, 100), (3, 1)])
def test_attention_stage_dp_kernel_matches_plain(np_rng, dtype, R, N):
    dev = _cuda()
    args = _t(_stage_inputs(np_rng, R, N, 512, w_scale=0.05), dev, dtype)
    args[0] = args[0] * 0.5
    dp = _dp_scales(np_rng, (R,), dev)
    n0 = tattn.attention_stage_dp.launches
    got = tattn.attention_stage_dp(*args, dp, 8, 0.125, 1e-6)
    want = tattn.attention_stage_dp_plain(*args, dp, 8, 0.125, 1e-6)
    torch.cuda.synchronize()
    assert tattn.attention_stage_dp.launches == n0 + 1
    for g, w in zip(got, want):
        assert _excess(g, w, dtype) <= 0
    assert torch.equal(got[0][0], args[0][0])  # a dropped sequence's branch vanishes


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 243, 17), (3, 17, 243)])
def test_mlp_block_t_dp_kernel_matches_plain(np_rng, dtype, shape):
    dev = _cuda()
    args = _t(_mlp_inputs(np_rng, *shape, 512, 1024), dev, dtype)
    dp = _dp_scales(np_rng, shape[:2], dev)
    n0 = tmlp.mlp_block_t_dp.launches
    got = tmlp.mlp_block_t_dp(*args, dp, 1e-6)
    want = tmlp.mlp_block_t_dp_plain(*args, dp, 1e-6)
    torch.cuda.synchronize()
    assert tmlp.mlp_block_t_dp.launches == n0 + 1
    assert _excess(got, want, dtype) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 17, 243])
def test_mlp_block_dp_kernel_matches_plain(np_rng, dtype, N):
    dev = _cuda()
    args = _t(_mlp_inputs(np_rng, 1, 3 * N, 1, 512, 1024), dev, dtype)
    args[:2] = [a.view(3 * N, 512) for a in args[:2]]
    dp = _dp_scales(np_rng, (3 * N,), dev)
    n0 = tmlp.mlp_block_dp.launches
    got = tmlp.mlp_block_dp(*args, dp, 1e-6)
    want = tmlp.mlp_block_dp_plain(*args, dp, 1e-6)
    torch.cuda.synchronize()
    assert tmlp.mlp_block_dp.launches == n0 + 1
    assert _excess(got, want, dtype) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dp_kernels_with_unit_scales_equal_the_kernels_without(np_rng, dtype):
    """dp = 1 multiplies exactly: the DropPath kernels then give the plain
    kernels' outputs bit for bit."""
    dev = _cuda()
    args = _t(_stage_inputs(np_rng, 6, 243, 512, w_scale=0.05), dev, dtype)
    for a, b in zip(tattn.attention_stage_dp(*args, torch.ones(6, device=dev), 8, 0.125, 1e-6),
                    tattn.attention_stage(*args, 8, 0.125, 1e-6)):
        assert torch.equal(a, b)
    margs = _t(_mlp_inputs(np_rng, 2, 17, 243, 512, 1024), dev, dtype)
    assert torch.equal(tmlp.mlp_block_t_dp(*margs, torch.ones(2, 17, device=dev), 1e-6),
                       tmlp.mlp_block_t(*margs, 1e-6))
    rows = [a.view(-1, 512) for a in margs[:2]] + margs[2:]
    assert torch.equal(tmlp.mlp_block_dp(*rows, torch.ones(2 * 17 * 243, device=dev), 1e-6),
                       tmlp.mlp_block(*rows, 1e-6))


# ------------------------------------------------- head-major stage (K8)
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N", [(64, 17), (6, 243), (5, 100), (3, 1)])
def test_attention_stage_hm_kernel_matches_plain_and_k1(np_rng, dtype, R, N):
    """K8 against its plain version at K1's tolerance, and equal to K1 bit
    for bit (the same products in the same order)."""
    dev = _cuda()
    args = _t(_stage_inputs(np_rng, R, N, 512, w_scale=0.05), dev, dtype)
    args[0] = args[0] * 0.5
    whm, bhm = tattn.stack_head_major(args[1], args[2], 8)
    hm = (args[0], whm, bhm, *args[3:])
    n0 = tattn.attention_stage_hm.launches
    got = tattn.attention_stage_hm(*hm, 8, 0.125, 1e-6)
    want = tattn.attention_stage_hm_plain(*hm, 8, 0.125, 1e-6)
    k1 = tattn.attention_stage(*args, 8, 0.125, 1e-6)
    torch.cuda.synchronize()
    assert tattn.attention_stage_hm.launches == n0 + 1
    for g, w, k in zip(got, want, k1):
        assert _excess(g, w, dtype) <= 0
        assert torch.equal(g, k)


# ----------------------------------------------- backwards (training, fp32)
@pytest.mark.gpu
@pytest.mark.parametrize("which", ["stage", "stage_dp", "block", "mlp", "mlp_dp", "mlp_t",
                                   "mlp_t_dp"])
def test_fused_backward_matches_autograd_of_plain(np_rng, which):
    """Each autograd Function on the card (kernel forward, plain-op backward
    around K3/K4) against torch.autograd through its plain forward, fp32:
    every gradient within 1e-3 relative in norm."""
    dev = _cuda()
    R, N = (6, 243) if which.startswith("stage") else (12, 17)
    if which.startswith("stage"):
        args = _t(_stage_inputs(np_rng, R, N, 512, w_scale=0.05), dev)
        dp = _dp_scales(np_rng, (R,), dev) if which == "stage_dp" else None
        fused = (lambda *a: tattn.attention_stage_dp_ad(*a, dp, 8, 0.125, 1e-6)) if dp is not None \
            else (lambda *a: tattn.attention_stage_ad(*a, 8, 0.125, 1e-6))
        plain = lambda *a: tattn.attention_stage_plain(*a, 8, 0.125, 1e-6, dp_row=dp)  # noqa
        outs = [(R, N, 512)] * 2
    elif which == "block":
        args = _block_inputs(np_rng, R, N, dev, torch.float32)
        fused = lambda *a: tattn.attention_block_ad(*a, 8, 0.125, 1e-6)  # noqa
        plain = lambda *a: tattn.attention_block_plain(*a, 8, 0.125, 1e-6)  # noqa
        outs = [(R, N, 512)] * 2
    else:
        args = _t(_mlp_inputs(np_rng, 2, R, N, 512, 1024), dev)
        t = which.startswith("mlp_t")
        if not t:
            args[:2] = [a.view(-1, 512) for a in args[:2]]
        dp = _dp_scales(np_rng, (2, R) if t else (2 * R * N,), dev) if "dp" in which else None
        ad = {(True, True): tmlp.mlp_block_t_dp_ad, (True, False): tmlp.mlp_block_t_ad,
              (False, True): tmlp.mlp_block_dp_ad, (False, False): tmlp.mlp_block_ad}
        f = ad[t, dp is not None]
        fused = (lambda *a: f(*a, dp, 1e-6)) if dp is not None else (lambda *a: f(*a, 1e-6))
        p = tmlp.mlp_block_t_plain if t else tmlp.mlp_block_plain
        plain = lambda *a: p(*a, 1e-6, dp)  # noqa: E731
        outs = [(2, N, R, 512) if t else (2 * R * N, 512)]
    cts = [torch.randn(s, device=dev) for s in outs]
    grads = []
    for fn in (fused, plain):
        leaves = [a.clone().requires_grad_(True) for a in args]
        o = fn(*leaves)
        grads.append(torch.autograd.grad(o if isinstance(o, tuple) else (o,), leaves, cts))
    torch.cuda.synchronize()
    for g, w in zip(*grads):
        assert ((g - w).norm() / w.norm()).item() <= 1e-3


@pytest.mark.gpu
def test_train_fused_step_launch_counts(monkeypatch):
    """D3DP_TRAIN_FUSED=1 at level 4, depth 2, DropPath 0.1: one train step
    launches K1 and K2 on the 2 rate-0 blocks, their DropPath forms on the
    other 2, and K3 + K4 once per stage backward."""
    from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
    from d3dp_tpu_torch.models import MixSTEConfig
    from d3dp_tpu_torch.train.state import make_optimizer, make_train_step

    dev = _cuda()
    monkeypatch.setenv("D3DP_TRAIN_FUSED", "1")
    d3dp = D3DP(D3DPConfig(model=MixSTEConfig(depth=2, drop_path_rate=0.1,
                                              dtype=torch.bfloat16)), seed=0)
    step = make_train_step(d3dp, make_optimizer(d3dp.model.parameters(), 6e-5))
    g = torch.Generator(device=dev).manual_seed(0)
    x2d = torch.randn(2, 243, 17, 2, generator=g, device=dev) * 0.3
    x3d = torch.randn(2, 243, 17, 3, generator=g, device=dev) * 0.3
    ops = (tattn.attention_stage, tattn.attention_stage_dp, tmlp.mlp_block_t,
           tmlp.mlp_block_t_dp, tattn.fused_attention_qkv, tattn.fused_attention_qkv_bwd)
    n0 = [f.launches for f in ops]
    loss = step(x2d, x3d, torch.ones(2, device=dev), generator=g)
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(ops, n0)] == [2, 2, 2, 2, 4, 4]
    assert torch.isfinite(loss)


@pytest.mark.gpu
def test_dp_and_hm_wrappers_raise_on_what_the_kernels_do_not_take(np_rng):
    dev = _cuda()
    args = _t(_stage_inputs(np_rng, 2, 17, 512), dev, torch.float32)
    with pytest.raises(ValueError, match="dp_row has shape"):
        tattn.attention_stage_dp(*args, torch.ones(3, device=dev), 8, 0.125, 1e-6)
    with pytest.raises(ValueError, match="dp_row has dtype"):
        tattn.attention_stage_dp(*args, torch.ones(2, device=dev).double(), 8, 0.125, 1e-6)
    with pytest.raises(ValueError, match="wqkv has shape"):
        tattn.attention_stage_hm(*args, 8, 0.125, 1e-6)
    margs = _t(_mlp_inputs(np_rng, 2, 9, 17, 512, 1024), dev, torch.bfloat16)
    with pytest.raises(ValueError, match="dp has shape"):
        tmlp.mlp_block_t_dp(*margs, torch.ones(2, 17, device=dev), 1e-6)
    rows = [a.view(-1, 512) for a in margs[:2]] + margs[2:]
    with pytest.raises(ValueError, match="dp is on"):
        tmlp.mlp_block_dp(*rows, torch.ones(2 * 9 * 17), 1e-6)


# ------------------------------------------------------------ lab switches
# name: (environment variable, value, the stage option it sets in bf16)
STAGE_SWITCHES = {"fold0": ("D3DP_SOFTMAX_FOLD", "0", tattn.OPT_NORM_FIRST),
                  "bf16exp": ("D3DP_ATTN_VARIANT", "bf16exp", tattn.OPT_BF16_EXP),
                  "noy2": ("D3DP_ATTN_VARIANT", "noy2", tattn.OPT_NO_Y2)}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("switch", ["fold0", "bf16exp", "noy2"])
@pytest.mark.parametrize("R,N", [(64, 17), (6, 243), (5, 100)])
def test_attention_stage_switch_kernels_match_plain(monkeypatch, np_rng, switch, dtype, R, N):
    """K1 under each stage switch against its plain version with the same
    options (TOL); noy2's x2 equal to production K1's bit for bit; fold0 and
    bf16exp also in the DropPath form, fold0 in K8 (equal to K1)."""
    dev = _cuda()
    name, value, opt = STAGE_SWITCHES[switch]
    args = _t(_stage_inputs(np_rng, R, N, 512, w_scale=0.05), dev, dtype)
    args[0] = args[0] * 0.5
    base = tattn.attention_stage(*args, 8, 0.125, 1e-6)
    monkeypatch.setenv(name, value)
    opts = opt if dtype == torch.bfloat16 or switch == "noy2" else 0
    n0 = tattn.attention_stage.launches
    got = tattn.attention_stage(*args, 8, 0.125, 1e-6)
    want = tattn.attention_stage_plain(*args, 8, 0.125, 1e-6, opts=opts)
    torch.cuda.synchronize()
    assert tattn.attention_stage.launches == n0 + 1
    if switch == "noy2":
        assert _excess(got[0], want[0], dtype) <= 0 and torch.equal(got[0], base[0])
        return
    for g, w in zip(got, want):
        assert _excess(g, w, dtype) <= 0
    dp = _dp_scales(np_rng, (R,), dev)
    for g, w in zip(tattn.attention_stage_dp(*args, dp, 8, 0.125, 1e-6),
                    tattn.attention_stage_dp_plain(*args, dp, 8, 0.125, 1e-6, opts=opts)):
        assert _excess(g, w, dtype) <= 0
    if switch == "fold0":
        hm = (args[0], *tattn.stack_head_major(args[1], args[2], 8), *args[3:])
        got_hm = tattn.attention_stage_hm(*hm, 8, 0.125, 1e-6)
        for g, w, k in zip(got_hm, tattn.attention_stage_hm_plain(*hm, 8, 0.125, 1e-6,
                                                                  opts=opts), got):
            assert _excess(g, w, dtype) <= 0 and torch.equal(g, k)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,R", [(2, 4), (8, 64), (15, 30), (18, 36)])
def test_grouped_attention_stage_kernel_matches_plain(monkeypatch, np_rng, dtype, g, R):
    """D3DP_SPATIAL_GROUP=g on 17-token sequences: K1 on the (R/g, 17g)
    fold with the block mask (g = 18: 306 keys, past 256) against the plain
    version on the same fold (TOL), and in fp32 against ungrouped K1."""
    dev = _cuda()
    args = _t(_stage_inputs(np_rng, R, 17, 512, w_scale=0.05), dev, dtype)
    args[0] = args[0] * 0.5
    ungrouped = tattn.attention_stage(*args, 8, 0.125, 1e-6)
    monkeypatch.setenv("D3DP_SPATIAL_GROUP", str(g))
    n0 = tattn.attention_stage.launches
    got = tattn.attention_stage(*args, 8, 0.125, 1e-6)
    want = tattn.attention_stage_plain(args[0].view(R // g, 17 * g, 512), *args[1:], 8, 0.125,
                                       1e-6, mask_block=17)
    torch.cuda.synchronize()
    assert tattn.attention_stage.launches == n0 + 1
    for gv, w, u in zip(got, want, ungrouped):
        assert _excess(gv, w.view(R, 17, 512), dtype) <= 0
        if dtype == torch.float32:
            assert _excess(gv, u, dtype) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["bf16gelu", "nogelu", ""])
@pytest.mark.parametrize("form", ["t", "t_dp", "rows", "rows_dp"])
def test_mlp_variant_kernels_match_plain(monkeypatch, np_rng, form, variant, dtype):
    """K2, K2-dp, K5 and K5-dp under D3DP_MLP_VARIANT ("" the production
    GELU) against their plain versions with the same activation (TOL), on
    3 x 243 x 17 = 12,393 token rows (41 in the bf16 tile's last 64);
    bf16gelu in fp32 is the exact GELU, bit for bit the production kernel."""
    dev = _cuda()
    args = _t(_mlp_inputs(np_rng, 3, 243, 17, 512, 1024), dev, dtype)
    t = form.startswith("t")
    if not t:
        args[:2] = [a.view(-1, 512) for a in args[:2]]
    dp = _dp_scales(np_rng, (3, 243) if t else (3 * 243 * 17,), dev) if "dp" in form else None
    op = {"t": tmlp.mlp_block_t, "t_dp": tmlp.mlp_block_t_dp, "rows": tmlp.mlp_block,
          "rows_dp": tmlp.mlp_block_dp}[form]
    plain = tmlp.mlp_block_t_plain if t else tmlp.mlp_block_plain
    run = (lambda: op(*args, dp, 1e-6)) if dp is not None else (lambda: op(*args, 1e-6))
    base = run()
    monkeypatch.setenv("D3DP_MLP_VARIANT", variant)
    gelu = tmlp.gelu_mode(dtype)
    n0 = op.launches
    got = run()
    want = plain(*args, 1e-6, dp, gelu=gelu)
    torch.cuda.synchronize()
    assert op.launches == n0 + 1
    assert _excess(got, want, dtype) <= 0
    assert torch.equal(got, base) == (gelu == tmlp.GELU_ERF)


@pytest.mark.gpu
@pytest.mark.parametrize("setting", [("D3DP_SOFTMAX_FOLD", "0"),
                                     ("D3DP_ATTN_VARIANT", "bf16exp"),
                                     ("D3DP_MLP_VARIANT", "bf16gelu"),
                                     ("D3DP_MLP_VARIANT", "nogelu")])
def test_resident_kernel_under_switch_matches_plain_and_level_4(monkeypatch, np_rng, setting):
    """K9 in bf16 under a global switch: at depth 1 against its plain version
    with the same options (TOL), and level 5 equal to level 4 bit for bit."""
    import dataclasses

    from d3dp_tpu_torch.ops import resident as tres

    dev = _cuda()
    monkeypatch.setenv(*setting)
    x, tpos, sp, tp, shared = _resident_inputs(np_rng, 2, 27, dev, torch.bfloat16, D=1)
    opts, gelu = tres.resident_options(torch.bfloat16)
    assert (opts, gelu) != (0, tmlp.GELU_ERF)
    got = tres.resident_block_stack(x, tpos, sp, tp, shared, 8, 0.125, 1e-6)
    want = tres.resident_block_stack_plain(x, tpos, sp, tp, shared, 8, 0.125, 1e-6, opts=opts,
                                           gelu=gelu)
    torch.cuda.synchronize()
    assert _excess(got, want, torch.bfloat16) <= 0
    model = _model(torch.bfloat16)
    x2d = torch.from_numpy(np_rng.randn(2, 243, 17, 2).astype(np.float32) * 0.3).to(dev)
    x3d = torch.from_numpy(np_rng.randn(2, 243, 17, 3).astype(np.float32)).to(dev)
    t = torch.tensor([999, 17], device=dev)
    out5 = model(x2d, x3d, t)
    model.cfg = dataclasses.replace(model.cfg, fuse_level=4)
    assert torch.equal(out5, model(x2d, x3d, t))


# The bf16 MLP tile takes 64 token rows (fp32: 16): fewer than one tile, one
# under and one over a multiple of 64, and 3 x 243 x 17 = 12,393 rows (41 in
# the last tile)
MLP_TILE_ROWS = [17, 63, 65, 127, 129, 12393]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", MLP_TILE_ROWS)
def test_mlp_block_tile_edges_match_plain(np_rng, dtype, R):
    """K5 and K5-dp on R token rows around the tile's 64 rows: the missing
    rows of the last tile are zero-filled on load and never stored."""
    dev = _cuda()
    args = _t(_mlp_inputs(np_rng, 1, R, 1, 512, 1024), dev, dtype)
    args[:2] = [a.view(R, 512) for a in args[:2]]
    dp = _dp_scales(np_rng, (R,), dev)
    n0 = tmlp.mlp_block.launches, tmlp.mlp_block_dp.launches
    got = tmlp.mlp_block(*args, 1e-6)
    got_dp = tmlp.mlp_block_dp(*args, dp, 1e-6)
    want = tmlp.mlp_block_plain(*args, 1e-6)
    want_dp = tmlp.mlp_block_dp_plain(*args, dp, 1e-6)
    torch.cuda.synchronize()
    assert (tmlp.mlp_block.launches, tmlp.mlp_block_dp.launches) == (n0[0] + 1, n0[1] + 1)
    assert got.shape == got_dp.shape == (R, 512)
    assert _excess(got, want, dtype) <= 0
    assert _excess(got_dp, want_dp, dtype) <= 0


def _level_4_chain(x, tpos, sp, tp, shared):
    """The depth-2 trunk as fuse level 4 runs it: K1 and K2 launches, the
    temporal position embedding added after the first spatial pair."""
    from d3dp_tpu_torch.ops import resident as tres

    B, F, J, C = x.shape
    h = x
    for d in range(2):
        stage, mlp = tres._kind(sp, d)
        x2, y2 = tattn.attention_stage(h.reshape(B * F, J, C), *stage, 8, 0.125, 1e-6)
        h = tmlp.mlp_block_t(y2.view(B, F, J, C), x2.view(B, F, J, C), *mlp, shared[0],
                             shared[1], 1e-6)
        if d == 0:
            h = h + tpos.to(x.dtype)
        stage, mlp = tres._kind(tp, d)
        x2, y2 = tattn.attention_stage(h.reshape(B * J, F, C), *stage, 8, 0.125, 1e-6)
        h = tmlp.mlp_block_t(y2.view(B, J, F, C), x2.view(B, J, F, C), *mlp, shared[2],
                             shared[3], 1e-6)
    return h


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resident_depth_2_with_a_partial_mlp_tile_equals_level_4_kernels(np_rng, dtype):
    """K9 at depth 2 on 3 rows of 27 frames (one group of 3 x 27 x 17 = 1,377
    token rows: 21 bf16 tiles of 64 and 33 rows, or 86 fp32 tiles of 16 and
    one row) equals the level-4 chain of K1 and K2 launches bit for bit."""
    from d3dp_tpu_torch.ops import resident as tres

    dev = _cuda()
    x, tpos, sp, tp, shared = _resident_inputs(np_rng, 3, 27, dev, dtype)
    assert tres.group_rows(3, 27, 17,
                           torch.cuda.get_device_properties(dev).multi_processor_count) == 3
    got = tres.resident_block_stack(x, tpos, sp, tp, shared, 8, 0.125, 1e-6)
    want = _level_4_chain(x, tpos, sp, tp, shared)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# (R, N) of 17, 63, 65, 127, 129 and 12,393 token rows: fewer than a stage
# tile of 64 rows (fp32: 16), one under and over one and two tiles, and 729
# spatial sequences (41 rows in the last tile)
STAGE_TILE_SHAPES = [(1, 17), (7, 9), (5, 13), (127, 1), (3, 43), (729, 17)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N", STAGE_TILE_SHAPES)
def test_stage_tile_edges_match_plain(monkeypatch, np_rng, dtype, R, N):
    """K1, K1-dp, K8, K1 under noy2 and K6 on token-row counts around the
    GEMM walks' 64-row tiles: the missing rows of the last tile are
    zero-filled on load and never stored. K8 equals K1 and noy2's x2 equals
    K1's, bit for bit."""
    dev = _cuda()
    args = _t(_stage_inputs(np_rng, R, N, 512, w_scale=0.05), dev, dtype)
    args[0] = args[0] * 0.5
    dp = _dp_scales(np_rng, (R,), dev)
    whm, bhm = tattn.stack_head_major(args[1], args[2], 8)
    hm = (args[0], whm, bhm, *args[3:])
    blk = _block_inputs(np_rng, R, N, dev, dtype)
    ops = (tattn.attention_stage, tattn.attention_stage_dp, tattn.attention_stage_hm,
           tattn.attention_block)
    n0 = [f.launches for f in ops]
    k1 = tattn.attention_stage(*args, 8, 0.125, 1e-6)
    pairs = [(k1, tattn.attention_stage_plain(*args, 8, 0.125, 1e-6)),
             (tattn.attention_stage_dp(*args, dp, 8, 0.125, 1e-6),
              tattn.attention_stage_dp_plain(*args, dp, 8, 0.125, 1e-6)),
             (tattn.attention_stage_hm(*hm, 8, 0.125, 1e-6),
              tattn.attention_stage_hm_plain(*hm, 8, 0.125, 1e-6)),
             (tattn.attention_block(*blk, 8, 0.125, 1e-6),
              tattn.attention_block_plain(*blk, 8, 0.125, 1e-6))]
    monkeypatch.setenv("D3DP_ATTN_VARIANT", "noy2")
    noy2 = tattn.attention_stage(*args, 8, 0.125, 1e-6)[0]
    noy2_want = tattn.attention_stage_plain(*args, 8, 0.125, 1e-6, opts=tattn.OPT_NO_Y2)[0]
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(ops, n0)] == [2, 1, 1, 1]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert g.shape == (R, N, 512)
            assert _excess(g, w, dtype) <= 0
    assert _excess(noy2, noy2_want, dtype) <= 0
    assert torch.equal(noy2, k1[0])
    assert all(torch.equal(g, k) for g, k in zip(pairs[2][0], k1))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resident_groups_equal_level_4_kernels(monkeypatch, np_rng, dtype):
    """K9 at depth 2 over three row groups (WAVES = 1 on the card's SMs: 40
    rows of 27 frames go as 14, 14 and 12, each group's 6,426 or 5,508
    token rows ending in a partial 64-row tile) equals the level-4 chain of
    K1 and K2 launches bit for bit."""
    from d3dp_tpu_torch.ops import resident as tres

    dev = _cuda()
    monkeypatch.setattr(tres, "WAVES", 1)
    x, tpos, sp, tp, shared = _resident_inputs(np_rng, 40, 27, dev, dtype)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    G = tres.group_rows(40, 27, 17, sms)
    assert 1 < G < 40 and (40 % G or G * 27 * 17 % 64)
    got = tres.resident_block_stack(x, tpos, sp, tp, shared, 8, 0.125, 1e-6)
    want = _level_4_chain(x, tpos, sp, tp, shared)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# the 3DHP evaluation's shapes (H=20, 2 windows a micro-batch, flip-TTA): 80
# hypothesis rows of 243 frames, 19,440 spatial sequences of 17 tokens and
# 1,360 temporal ones of 243
ROWS_3DHP = 80


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N", [(ROWS_3DHP * 243, 17), (ROWS_3DHP * 17, 243)])
def test_attention_stage_kernel_matches_plain_at_3dhp_rows(np_rng, dtype, R, N):
    dev = _cuda()
    args = _t(_stage_inputs(np_rng, R, N, 512, w_scale=0.05), dev, dtype)
    args[0] = args[0] * 0.5
    n0 = tattn.attention_stage.launches
    got = tattn.attention_stage(*args, 8, 0.125, 1e-6)
    want = tattn.attention_stage_plain(*args, 8, 0.125, 1e-6)
    torch.cuda.synchronize()
    assert tattn.attention_stage.launches == n0 + 1
    for g, w in zip(got, want):
        assert _excess(g, w, dtype) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(ROWS_3DHP, 243, 17), (ROWS_3DHP, 17, 243)])
def test_mlp_block_t_kernel_matches_plain_at_3dhp_rows(np_rng, dtype, shape):
    dev = _cuda()
    args = _t(_mlp_inputs(np_rng, *shape, 512, 1024), dev, dtype)
    n0 = tmlp.mlp_block_t.launches
    got = tmlp.mlp_block_t(*args, 1e-6)
    want = tmlp.mlp_block_t_plain(*args, 1e-6)
    torch.cuda.synchronize()
    assert tmlp.mlp_block_t.launches == n0 + 1
    assert _excess(got, want, dtype) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_resident_depth_2_at_3dhp_rows_equals_level_4_kernels(np_rng, dtype):
    """K9 at depth 2 on the 80 rows of 243 frames, in `group_rows`' grouping
    for them, equals the level-4 chain of K1 and K2 launches bit for bit."""
    from d3dp_tpu_torch.ops import resident as tres

    dev = _cuda()
    x, tpos, sp, tp, shared = _resident_inputs(np_rng, ROWS_3DHP, 243, dev, dtype)
    n0 = tres.resident_block_stack.launches
    got = tres.resident_block_stack(x, tpos, sp, tp, shared, 8, 0.125, 1e-6)
    want = _level_4_chain(x, tpos, sp, tp, shared)
    torch.cuda.synchronize()
    assert tres.resident_block_stack.launches == n0 + 1
    assert torch.equal(got, want)

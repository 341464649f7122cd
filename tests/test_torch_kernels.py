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


# the backward's own tiles: bf16 a warp a tile at 16 and 32 keys, a block a
# tile of 64, 128 or 256 keys above; fp32 two warps a tile at 16 and 32
# keys, above 64-row tiles over groups of 32 keys (N = 1, 8, 31, 32, 33, 63,
# 64, 65, 127, 128, 129, 192, 243, 255, 256 with the shapes above)
BWD_EDGE_SHAPES = [(6, 16), (4, 48), (4, 63), (3, 64), (3, 128), (3, 129), (3, 8), (3, 31),
                   (3, 127)]
BWD_SHAPES = QKV_SHAPES + TILE_EDGE_SHAPES + BWD_EDGE_SHAPES


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,N", BWD_SHAPES)
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [17, 243])
def test_fused_attention_qkv_bwd_is_deterministic(np_rng, dtype, N):
    """Two calls give the same bits, and a sequence's d(qkv) does not depend
    on the other sequences of the batch (R = 1 against R = 5)."""
    dev = _cuda()
    qkv, dout = _qkv_inputs(np_rng, 5, N, dev, dtype)
    a = tattn.fused_attention_qkv_bwd(qkv, dout, 8, 0.125)
    b = tattn.fused_attention_qkv_bwd(qkv, dout, 8, 0.125)
    one = tattn.fused_attention_qkv_bwd(qkv[2:3].contiguous(), dout[2:3].contiguous(), 8, 0.125)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert torch.equal(one[0], a[2])


@pytest.mark.gpu
@pytest.mark.parametrize("R,N", BWD_SHAPES)
def test_fused_attention_qkv_bwd_kernel_matches_autograd_of_plain(np_rng, R, N):
    """fp32: the backward kernel (three TF32 passes a product) against
    torch.autograd through the plain forward, at every tile edge."""
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


# The short tile (bf16, N <= 32 unmasked keys): every query and key
# fragment edge (1, 2, 16, 17, 31, 32 tokens), rows R of one sequence, 7,
# the eval path's 9,720 spatial sequences and the train step's 4 x 243, so
# the ring's last stages are partly filled and a block may hold no tile.
SHORT_NS = [1, 2, 16, 17, 31, 32]
SHORT_RS = [1, 7, 9720, 4 * 243]


def _short_qkv(R, N, seed):
    """Unit-normal packed qkv (R, N, 3 x 512) in bf16, drawn on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(R, N, 1536, generator=g, device="cuda").to(torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("opts", [0, tattn.OPT_NORM_FIRST, tattn.OPT_BF16_EXP,
                                  tattn.OPT_NORM_FIRST | tattn.OPT_BF16_EXP])
@pytest.mark.parametrize("N", SHORT_NS)
@pytest.mark.parametrize("R", SHORT_RS)
def test_short_tile_packed_matches_plain(R, N, opts):
    """The short tile on the packed layout (K1's attend launch) against its
    plain version at TOL_QKV, under each switch that reaches it."""
    _cuda()
    qkv = _short_qkv(R, N, 100 * N + R % 97)
    n0 = tattn.attend_qkv.launches
    got = tattn.attend_qkv(qkv, 8, 0.125, opts)
    want = tattn.attend_qkv_plain(qkv, 8, 0.125, opts)
    torch.cuda.synchronize()
    assert tattn.attend_qkv.launches == n0 + 1
    assert got.shape == (R, N, 512) and bool(torch.isfinite(got).all())
    assert _excess(got, want, torch.bfloat16, TOL_QKV) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("N", SHORT_NS)
@pytest.mark.parametrize("R", SHORT_RS)
def test_short_tile_separate_matches_plain(R, N):
    """The short tile on separate q, k, v (K7) against its plain version."""
    _cuda()
    q, k, v = (t.contiguous() for t in _short_qkv(R, N, 200 * N + R % 89).split(512, dim=-1))
    n0 = tattn.fused_attention_packed.launches
    got = tattn.fused_attention_packed(q, k, v, 8, 0.125)
    want = tattn.fused_attention_plain(q, k, v, 8, 0.125)
    torch.cuda.synchronize()
    assert tattn.fused_attention_packed.launches == n0 + 1
    assert _excess(got, want, torch.bfloat16, TOL_QKV) <= 0
    # the same tile on the packed layout with p / l first (K3's order)
    qkv = torch.cat([q, k, v], dim=-1)
    assert torch.equal(got, tattn.fused_attention_qkv(qkv, 8, 0.125))


@pytest.mark.gpu
@pytest.mark.parametrize("N", SHORT_NS)
@pytest.mark.parametrize("R", SHORT_RS)
def test_short_tile_head_major_stage_matches_plain_and_k1(np_rng, R, N):
    """K8 (the short tile on head-major slabs) against its plain version at
    K1's tolerance and equal to K1 (the packed layout) bit for bit."""
    dev = _cuda()
    args = _t(_stage_inputs(np_rng, 1, 1, 512, w_scale=0.05), dev, torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(N)
    args[0] = (torch.randn(R, N, 512, generator=g, device=dev) * 0.5).to(torch.bfloat16)
    whm, bhm = tattn.stack_head_major(args[1], args[2], 8)
    hm = (args[0], whm, bhm, *args[3:])
    n0, n1 = tattn.attention_stage_hm.launches, tattn.attention_stage.launches
    got = tattn.attention_stage_hm(*hm, 8, 0.125, 1e-6)
    want = tattn.attention_stage_hm_plain(*hm, 8, 0.125, 1e-6)
    k1 = tattn.attention_stage(*args, 8, 0.125, 1e-6)
    torch.cuda.synchronize()
    assert tattn.attention_stage_hm.launches == n0 + 1
    assert tattn.attention_stage.launches == n1 + 1
    for gt, w, k in zip(got, want, k1):
        assert _excess(gt, w, torch.bfloat16) <= 0
        assert torch.equal(gt, k)


@pytest.mark.gpu
@pytest.mark.parametrize("op", ["attend", "packed", "stage_hm"])
@pytest.mark.parametrize("N", SHORT_NS)
def test_short_tile_rows_do_not_depend_on_the_batch(np_rng, op, N):
    """A sequence alone equals itself inside R = 5, bit for bit, on each
    source layout of the short tile."""
    dev = _cuda()
    qkv = _short_qkv(5, N, 300 + N)
    if op == "attend":
        run = lambda a, b: tattn.attend_qkv(qkv[a:b], 8, 0.125)  # noqa: E731
    elif op == "packed":
        q, k, v = (t.contiguous() for t in qkv.split(512, dim=-1))
        run = lambda a, b: tattn.fused_attention_packed(q[a:b], k[a:b], v[a:b], 8, 0.125)  # noqa
    else:
        args = _t(_stage_inputs(np_rng, 5, N, 512, w_scale=0.05), dev, torch.bfloat16)
        whm, bhm = tattn.stack_head_major(args[1], args[2], 8)
        run = lambda a, b: tattn.attention_stage_hm(args[0][a:b] * 0.5, whm, bhm, *args[3:],  # noqa
                                                    8, 0.125, 1e-6)[0]
    five = run(0, 5)
    for i in range(5):
        assert torch.equal(run(i, i + 1)[0], five[i])


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


def _rank_share(n_parts, width, tp, j):
    """Indices of rank j's share of an axis of n_parts parts of `width`."""
    per = width // tp
    return torch.cat([torch.arange(p * width + j * per, p * width + (j + 1) * per)
                      for p in range(n_parts)])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("R,N", [(64, 17), (6, 243), (3, 1)])
def test_tp_partial_forms_match_plain(np_rng, dtype, tp, R, N):
    """The tensor-parallel forms on each rank's share at C=512, 8 heads:
    K1-tp, K6-tp and K2/K5-tp against their plain versions (fp32 outputs,
    so the bf16 ulp term is that of fp32 values), and residual_ln in both
    layouts against its plain version."""
    from d3dp_tpu_torch.ops import residual_ln as trl

    dev = _cuda()
    C, heads, H = 512, 8, 1024
    a = _t(_stage_inputs(np_rng, R, N, C), dev, dtype)
    m = _t(_mlp_inputs(np_rng, R, N, 1, C, H), dev, dtype)
    qkv = torch.from_numpy(np_rng.randn(R, N, 3 * C).astype(np.float32)).to(dev, dtype)
    for j in range(tp):
        qi = _rank_share(3, C, tp, j).to(dev)
        cs, hs = _rank_share(1, C, tp, j).to(dev), _rank_share(1, H, tp, j).to(dev)
        stage = (a[0], a[1][:, qi].contiguous(), a[2][qi].contiguous(), a[5], a[6],
                 a[3][cs].contiguous())
        block = (qkv[..., qi].contiguous(), a[3][cs].contiguous())
        mlp = (m[0].reshape(-1, C), m[2][:, hs].contiguous(), m[3][hs].contiguous(),
               m[4][hs].contiguous())
        for got, want in (
                (tattn.attention_stage_partial(*stage, heads // tp, 0.125, 1e-6),
                 tattn.attention_stage_partial_plain(*stage, heads // tp, 0.125, 1e-6)),
                (tattn.attention_block_partial(*block, heads // tp, 0.125),
                 tattn.attention_block_partial_plain(*block, heads // tp, 0.125)),
                (tmlp.mlp_block_partial(*mlp), tmlp.mlp_block_partial_plain(*mlp))):
            torch.cuda.synchronize()
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert _excess(got, want, dtype) <= 0
    part = torch.from_numpy(np_rng.randn(R, N, 1, C).astype(np.float32)).to(dev)
    for transpose in (False, True):
        args = (m[1], part, m[5], m[6], m[7], 1e-6)
        got = trl.residual_ln(*args, transpose=transpose)
        want = trl.residual_ln_plain(*args, transpose=transpose)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.dtype == dtype and g.shape == w.shape
            assert _excess(g, w, dtype) <= 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("R,N", [(64, 17), (6, 243), (3, 1), (7, 9)])
def test_tp_hm_partial_matches_plain_and_k1_tp(np_rng, dtype, tp, R, N):
    """K8-tp (the head-major stage's partial form) on each rank's
    head-major stacks at C=512, 8 heads: against its plain version, and
    equal to K1-tp's partial on the same rank bit for bit (both load each
    64-column box of the qkv weights to the same place)."""
    dev = _cuda()
    C, heads = 512, 8
    a = _t(_stage_inputs(np_rng, R, N, C), dev, dtype)
    for j in range(tp):
        qi = _rank_share(3, C, tp, j).to(dev)
        cs = _rank_share(1, C, tp, j).to(dev)
        stage = (a[0], a[1][:, qi].contiguous(), a[2][qi].contiguous(), a[5], a[6],
                 a[3][cs].contiguous())
        hm = (stage[0], *tattn.stack_head_major(stage[1], stage[2], heads // tp), *stage[3:])
        got = tattn.attention_stage_hm_partial(*hm, heads // tp, 0.125, 1e-6)
        want = tattn.attention_stage_hm_partial_plain(*hm, heads // tp, 0.125, 1e-6)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32 and got.shape == want.shape == (R, N, C)
        assert _excess(got, want, dtype) <= 0
        assert torch.equal(got, tattn.attention_stage_partial(*stage, heads // tp, 0.125, 1e-6))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["attention", "mlp_rows", "mlp_t"])
def test_residual_ln_dp_kernel_matches_plain(np_rng, dtype, layout):
    """residual_ln with its DropPath scale against its plain version: dp
    (R,) over (R, N, C) rows of 17 tokens (x2 and y), dp (B, D1) over (B,
    D1, D2, C) rows, in place and transposed (y); unit scales equal the op
    without them bit for bit."""
    from d3dp_tpu_torch.ops import residual_ln as trl

    dev = _cuda()
    C = 512
    shape = (130, 17, C) if layout == "attention" else (3, 27, 17, C)
    res = torch.from_numpy(np_rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    part = torch.from_numpy(np_rng.randn(*shape).astype(np.float32)).to(dev)
    vec = [torch.from_numpy((np_rng.randn(C) * s + o).astype(np.float32)).to(dev)
           for s, o in ((0.02, 0.0), (0.1, 1.0), (0.1, 0.0))]
    dp_shape = shape[:1] if layout == "attention" else shape[:2]
    dp = torch.from_numpy(np.where(np_rng.rand(*dp_shape) < 0.9, 1 / 0.9, 0.0)
                          .astype(np.float32)).to(dev)
    kw = {} if layout == "attention" else dict(with_x2=False, transpose=layout == "mlp_t")
    got = trl.residual_ln(res, part, *vec, 1e-6, dp=dp, **kw)
    want = trl.residual_ln_plain(res, part, *vec, 1e-6, dp=dp, **kw)
    ones = trl.residual_ln(res, part, *vec, 1e-6, dp=torch.ones_like(dp), **kw)
    without = trl.residual_ln(res, part, *vec, 1e-6, **kw)
    torch.cuda.synchronize()
    if layout != "attention":
        got, want, ones, without = (got,), (want,), (ones,), (without,)
    for g, w, o, n in zip(got, want, ones, without):
        assert g.dtype == dtype and g.shape == w.shape
        assert _excess(g, w, dtype) <= 0
        assert torch.equal(o, n)


# fp32's tf32x3 walks (csrc/mlp.cuh, "fp32: tf32x3"): token-row counts one
# under and over one and two 64-row tiles
F32_WALK_ROWS = [(7, 9), (5, 13), (127, 1), (3, 43)]


@pytest.mark.gpu
@pytest.mark.parametrize("R,N", F32_WALK_ROWS)
def test_fp32_walks_on_given_planes_match_plain(np_rng, R, N):
    """K1, K8, K6, K5 and K2 in fp32 on 63, 65, 127 and 129 token rows:
    within 1e-4 of their plain versions, the same bits whether the caller
    passes the weights' TF32 planes (`planes`, as the model's weight cache
    does) or the op makes them; K8 equal to K1."""
    from d3dp_tpu_torch.ops import tf32

    dev = _cuda()
    f32 = torch.float32
    a = _t(_stage_inputs(np_rng, R, N, 512, w_scale=0.05), dev, f32)
    a[0] = a[0] * 0.5
    k1 = tattn.attention_stage(*a, 8, 0.125, 1e-6)
    pa = (tf32.planes(a[1]), tf32.planes(a[3]))
    k1_given = tattn.attention_stage(*a, 8, 0.125, 1e-6, planes=pa)
    hm = [a[0], *tattn.stack_head_major(a[1], a[2], 8), *a[3:]]
    k8 = tattn.attention_stage_hm(*hm, 8, 0.125, 1e-6, planes=(tf32.planes(hm[1]), pa[1]))
    b = _block_inputs(np_rng, R, N, dev, f32)
    k6 = tattn.attention_block(*b, 8, 0.125, 1e-6, planes=(tf32.planes(b[2]),))
    m = _t(_mlp_inputs(np_rng, 1, R, N, 512, 1024), dev, f32)
    k2 = tmlp.mlp_block_t(*m, 1e-6)
    pm = (tf32.planes(m[2]), tf32.planes(m[4]))
    rows = [t.view(R * N, 512) for t in m[:2]] + m[2:]
    k5 = tmlp.mlp_block(*rows, 1e-6, planes=pm)
    torch.cuda.synchronize()
    for got, want in ((k1, tattn.attention_stage_plain(*a, 8, 0.125, 1e-6)),
                      (k6, tattn.attention_block_plain(*b, 8, 0.125, 1e-6)),
                      ((k5,), (tmlp.mlp_block_plain(*rows, 1e-6),)),
                      ((k2,), (tmlp.mlp_block_t_plain(*m, 1e-6),))):
        for g, w in zip(got, want):
            assert _excess(g, w, f32) <= 0
    assert all(torch.equal(g, w) for g, w in zip(k1_given, k1))
    assert all(torch.equal(g, w) for g, w in zip(k8, k1))
    assert torch.equal(k2, tmlp.mlp_block_t(*m, 1e-6, planes=pm))


@pytest.mark.gpu
@pytest.mark.parametrize("R,N", [(3, 1), (9, 8), (7, 16), (5, 17), (3, 32), (3, 33), (2, 64),
                                 (2, 65), (2, 100), (2, 128), (2, 129), (2, 243), (2, 256)])
def test_fp32_attention_tile_matches_plain(np_rng, R, N):
    """The fp32 attention: the short tile (FMAs) up to 32 keys, the
    tensor-core walk (tf32x3 mma.sync) above, at its 64-key groups' edges
    and on either side of its switch from one 16-row block a warp to two
    (128 / 129): K1's attend launch, K3 and K7 against their plain versions
    at 1e-4."""
    dev = _cuda()
    qkv, _ = _qkv_inputs(np_rng, R, N, dev, torch.float32)
    q, k, v = (t.contiguous() for t in qkv.split(512, dim=-1))
    for got, want in ((tattn.attend_qkv(qkv, 8, 0.125), tattn.attend_qkv_plain(qkv, 8, 0.125)),
                      (tattn.fused_attention_qkv(qkv, 8, 0.125),
                       tattn.fused_attention_qkv_plain(qkv, 8, 0.125)),
                      (tattn.fused_attention_packed(q, k, v, 8, 0.125),
                       tattn.fused_attention_plain(q, k, v, 8, 0.125))):
        torch.cuda.synchronize()
        assert got.shape == (R, N, 512)
        assert _excess(got, want, torch.float32, TOL_QKV) <= 0


@pytest.mark.gpu
def test_fp32_resident_on_given_planes_equals_level_4_chain(np_rng):
    """K9 at depth 2 in fp32 on the weight stacks' TF32 planes, as the
    model's weight cache passes them, equals the level-4 chain of K1 and K2
    launches on per-block views of those planes, bit for bit, and K9 on
    planes it makes itself."""
    from d3dp_tpu_torch.ops import resident as tres
    from d3dp_tpu_torch.ops import tf32

    dev = _cuda()
    x, tpos, sp, tp, shared = _resident_inputs(np_rng, 3, 27, dev, torch.float32)
    want = tres.resident_block_stack(x, tpos, sp, tp, shared, 8, 0.125, 1e-6)
    planes = tuple(tuple(tf32.planes(kind[i]) for i in (0, 2, 3, 5)) for kind in (sp, tp))
    got = tres.resident_block_stack(x, tpos, sp, tp, shared, 8, 0.125, 1e-6, planes=planes)
    B, F, J, C = x.shape
    h = x
    for d in range(2):
        for kind, pk, (R, N, D1), ns in ((sp, planes[0], (B * F, J, F), shared[:2]),
                                         (tp, planes[1], (B * J, F, J), shared[2:])):
            stage, mlp = tres._kind(kind, d)
            x2, y2 = tattn.attention_stage(h.reshape(R, N, C), *stage, 8, 0.125, 1e-6,
                                           planes=(pk[0][d], pk[1][d]))
            h = tmlp.mlp_block_t(y2.view(B, D1, N, C), x2.view(B, D1, N, C), *mlp, *ns, 1e-6,
                                 planes=(pk[2][d], pk[3][d]))
            if d == 0 and kind is sp:
                h = h + tpos
    torch.cuda.synchronize()
    assert torch.equal(got, h)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["proj", "fc1", "fc2"])
def test_fp32_walks_against_float64(np_rng, name):
    """Each contraction of the fp32 walks at its whole K (the projection's o
    @ Wp over C = 512, fc1 over C, fc2 over H = 1024), read through the
    partial forms' walks on the whole contraction (`utils.fp32_accuracy`),
    at the card tests' stage and MLP inputs: within half the fp32 band
    (0.5e-4) of the same operands multiplied in float64 on the card. TOL
    holds each kernel to its plain fp32 version; this holds the walks'
    accumulation to the exact product."""
    from d3dp_tpu_torch.utils.fp32_accuracy import contraction_errors

    dev = _cuda()
    x, wqkv, bqkv, wp, _, ln1_s, ln1_b = _t(_stage_inputs(np_rng, 64, 17, 512), dev)[:7]
    y, _, w1, b1, w2 = _t(_mlp_inputs(np_rng, 64, 17, 1, 512, 1024), dev)[:5]
    y1 = torch.nn.functional.layer_norm(x.double(), (512,), ln1_s.double(), ln1_b.double(), 1e-6)
    qkv = (y1 @ wqkv.double() + bqkv.double()).float()
    r = contraction_errors(qkv, wp, y.view(-1, 512), w1, b1, w2, 8, 0.125)[name]
    assert r["kernel"] <= 0.5e-4, r


# The composed train step's block linears on the tf32x3 GEMM (`ops.linear`):
# (in, out) of qkv, proj, fc1 and fc2; each product at the train step's
# 16,524 token rows (a ragged last tile of 12) and at two small ragged counts
LINEARS = {"qkv": (512, 1536), "proj": (512, 512), "fc1": (512, 1024), "fc2": (1024, 512)}


@pytest.mark.gpu
@pytest.mark.parametrize("orient", ["forward", "input gradient"])
@pytest.mark.parametrize("name", list(LINEARS))
def test_linear_tf32x3_against_float64_and_cublas(name, orient):
    """The GEMM's distance from float64 (max |diff| over the output's
    largest magnitude) is at most twice cuBLAS's fp32 product's (TF32 off:
    FFMA) on the same inputs: forward x @ W^T + b on W's planes, input
    gradient dY @ W on W^T's."""
    from d3dp_tpu_torch.ops import linear as L

    dev = _cuda()
    k_in, n_out = LINEARS[name]
    g = torch.Generator(device=dev).manual_seed(k_in + n_out)
    w = torch.randn(n_out, k_in, generator=g, device=dev) * 0.02
    b = torch.randn(n_out, generator=g, device=dev) * 0.02
    fwd = orient == "forward"
    p, pt = L.split_planes(w, transposed=True)
    K = k_in if fwd else n_out
    for M in (16524, 17, 129):
        a = torch.randn(M, K, generator=g, device=dev) * (1.0 if fwd else 1e-3)
        if fwd:
            got, lib = L.gemm(a, p, b), torch.nn.functional.linear(a, w, b)
            want = a.double() @ w.double().t() + b.double()
        else:
            got, lib = L.gemm(a, pt), a @ w
            want = a.double() @ w.double()
        torch.cuda.synchronize()
        err, err_lib = ((t.double() - want).abs().max() / want.abs().max() for t in (got, lib))
        assert err <= 2 * err_lib, (M, err.item(), err_lib.item())


@pytest.mark.gpu
def test_split_planes_equal_tf32_planes():
    """The split kernel's planes of W (N, K) and, in the same launch, of W^T
    equal `ops.tf32.planes`, bit for bit, at each block linear's shape and
    at a shape of partial 32 x 32 tiles."""
    from d3dp_tpu_torch.ops import linear as L
    from d3dp_tpu_torch.ops import tf32

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(0)
    for k_in, n_out in (*LINEARS.values(), (45, 70)):
        w = torch.randn(n_out, k_in, generator=g, device=dev)
        p, pt = L.split_planes(w, transposed=True)
        assert torch.equal(p, tf32.planes(w.t())) and torch.equal(pt, tf32.planes(w))
        assert torch.equal(L.split_planes(w)[0], p) and L.split_planes(w)[1] is None


@pytest.mark.gpu
def test_composed_fp32_step_counts_its_linears():
    """One composed fp32 train step at the published width (depth 2): the
    GEMM launches 4 linears x 2 (forward, input gradient) x 2 x depth
    blocks times, counted by `.launches` and, under a profiler, by the
    recorder's `linear_tf32x3`; a bf16 step launches none."""
    from torch.profiler import ProfilerActivity, profile

    from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
    from d3dp_tpu_torch.models import MixSTEConfig
    from d3dp_tpu_torch.ops import linear as L
    from d3dp_tpu_torch.train.state import make_optimizer, make_train_step
    from d3dp_tpu_torch.utils import profiling

    dev = _cuda()
    depth = 2
    r = np.random.RandomState(0)
    x2d = (r.randn(4, 27, 17, 2) * 0.3).astype(np.float32)
    x3d = (r.randn(4, 27, 17, 3) * 0.3).astype(np.float32)
    for dtype, want in ((torch.float32, 16 * depth), (torch.bfloat16, 0)):
        cfg = MixSTEConfig(num_frames=27, embed_dim=512, depth=depth, num_heads=8,
                           drop_path_rate=0.1, dtype=dtype)
        td = D3DP(D3DPConfig(model=cfg), device=dev, seed=0)
        step = make_train_step(td, make_optimizer(td.model.parameters(), 6e-5))
        g = torch.Generator(device=dev).manual_seed(1)
        step(x2d, x3d, np.ones(4, np.float32), generator=g)  # warm-up
        n0 = L.gemm.launches
        profiling.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            loss = step(x2d, x3d, np.ones(4, np.float32), generator=g)
        torch.cuda.synchronize()
        assert torch.isfinite(loss)
        assert L.gemm.launches - n0 == want
        assert profiling.counters().get("linear_tf32x3", 0) == want

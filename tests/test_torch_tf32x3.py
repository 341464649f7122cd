"""The three-pass TF32 products of the fp32 kernels, and their weight planes.

The fp32 walks (`csrc/mlp.cuh`, "fp32: tf32x3") split each operand v into
hi = tf32(v) and lo = tf32(v - hi) (`cvt.rna.tf32.f32`: to nearest, ties
away from zero) and add, at each k-step of 8, lo(A) hi(B), hi(A) lo(B) and
hi(A) hi(B) into one fp32 accumulator. No CUDA runs here, so the scheme is
emulated in plain torch (test code only: the split on the bits, each
k-step's three 8-deep products in fp32, in the kernel's order) and held

  * against float64: its error is at most the larger of 4x a plain fp32
    product's and 2e-6 (relative to the output's largest magnitude), far
    inside the 1e-4 the card holds the fp32 kernels to;
  * against JAX's Precision.HIGHEST on the CPU: the fp32 parity 2e-5, on
    one stage's and one MLP's products at the model's scales;
  * as the tensor-parallel partial forms split them: each rank's product
    over its share of the contraction, summed over the ranks, at the same
    two bands at tp = 2, 4, 8;
  * under a model of the tensor cores' truncating accumulation
    (`tf32x3_tc`), at the card tests' inputs: the qkv walk's promoted
    stages keep K1-tp inside the card's fp32 band where one accumulator
    over K does not; the projection's and fc2's, promoted too, stay within
    half of it whole and partial; fc1, on one accumulator, as the card read
    it (within half the band); the model 2-14% above the card's readings;
  * `utils/fp32_accuracy.py`, which reads those walks against float64 on
    the card, on the CPU: its selectors return the walks' operands exactly.

The weight planes the kernels read (`ops.tf32.planes`, made once per
weight version in `MixSTE2._weights` and passed to the ops as `planes`)
rebuild each weight within 2^-22 of it; the cache makes them anew after an
optimizer step, an in-place edit (also under torch.inference_mode) and a
`.data` swap, and the model hands them to every fp32 op it calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3dp_tpu_torch.models import MixSTEConfig
from d3dp_tpu_torch.models.mixste import MixSTE2
from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.ops import tf32
from d3dp_tpu_torch.train.state import make_optimizer
from tests.test_torch_kernels import _mlp_inputs, _stage_inputs
from tests.test_torch_model import SMALL

torch.set_num_threads(1)

# weights of the model's init (std 0.02) and of unit scale; LayerNorm outputs
SCALES = {"weights 0.02": 0.02, "weights 1": 1.0}


def _tf32(a):
    """float32 array a rounded as cvt.rna.tf32.f32 rounds: the magnitude to
    10 mantissa bits, halfway cases away from zero."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    mag = ((u & 0x7FFFFFFF) + 0x1000) & 0xFFFFE000
    return ((u & 0x80000000) | mag).view(np.float32)


def _split(a):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def tf32x3(a, b):
    """a (M, K) @ b (K, N), float32, as the kernels compute it: per k-step of
    8, lo(a) hi(b), hi(a) lo(b), hi(a) hi(b) added in that order."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    ah, al, bh, bl = (torch.from_numpy(t) for t in (ah, al, bh, bl))
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = acc + x[:, s] @ y[s]
    return acc.numpy()


def _ln_rows(rng, M, K):
    """LayerNorm outputs: unit-variance rows through a scale near 1 and a
    small shift, float32."""
    x = rng.randn(M, K)
    y = (x - x.mean(1, keepdims=True)) / x.std(1, keepdims=True)
    return (y * (1 + 0.1 * rng.randn(K)) + 0.1 * rng.randn(K)).astype(np.float32)


def _rel(got, want):
    return np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("scale", [*SCALES.values(), "ln"], ids=[*SCALES, "ln outputs"])
def test_planes_rebuild_each_weight(scale):
    """hi is w rounded as cvt.rna rounds it (the low 13 bits zero), and
    hi + lo is within 2^-22 of w; the planes are w's transpose, (2, N, K)."""
    rng = np.random.RandomState(1)
    w = _ln_rows(rng, 512, 192) if scale == "ln" else \
        (rng.randn(512, 192) * scale).astype(np.float32)
    p = tf32.planes(torch.from_numpy(w))
    assert p.shape == (2, 192, 512) and p.dtype == torch.float32 and p.is_contiguous()
    hi, lo = p[0].numpy().T, p[1].numpy().T
    np.testing.assert_array_equal(hi, _tf32(w))
    assert not (hi.view(np.uint32) & 0x1FFF).any() and not (lo.view(np.uint32) & 0x1FFF).any()
    err = np.abs(hi.astype(np.float64) + lo - w)
    assert (err <= 2.0 ** -22 * np.abs(w)).all()


def test_round_tf32_takes_halfway_cases_away_from_zero():
    """The package's rounding equals the bitwise one, halfway cases included:
    1 + 2^-11 (halfway between 1 and 1 + 2^-10) goes up, as does -(1 + 2^-11)
    away from zero; one bit below halfway goes down."""
    one = np.float32(1.0).view(np.uint32)
    cases = np.array([one + 0x1000, one + 0x0FFF, one + 0x3000, one + 0x1FFF],
                     dtype=np.uint32).view(np.float32)
    cases = np.concatenate([cases, -cases])
    got = tf32.round_tf32(torch.from_numpy(cases)).numpy()
    np.testing.assert_array_equal(got, _tf32(cases))
    assert got[0] == np.float32(1 + 2.0 ** -10) and got[1] == np.float32(1.0)
    assert got[4] == -np.float32(1 + 2.0 ** -10)


@pytest.mark.parametrize("K", [512, 1024])
@pytest.mark.parametrize("scale", list(SCALES.values()), ids=list(SCALES))
def test_tf32x3_error_against_float64(K, scale):
    """LayerNorm outputs (64 rows) times weights: the scheme's error is at
    most the larger of 4x a plain fp32 product's and 2e-6."""
    rng = np.random.RandomState(K)
    a = _ln_rows(rng, 64, K)
    b = (rng.randn(K, 192) * scale).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    err_x3 = _rel(tf32x3(a, b), want)
    err_f32 = _rel((torch.from_numpy(a) @ torch.from_numpy(b)).numpy(), want)
    assert err_x3 <= max(4 * err_f32, 2e-6), (err_x3, err_f32)
    # one TF32 pass would not do: the scheme is what keeps fp32 accuracy
    assert _rel(_tf32(a) @ _tf32(b), want) > 10 * err_x3


# one stage's products (LN1(x) @ Wqkv, o @ Wp) and one MLP's (y2 @ W1,
# GELU(h) @ W2) at the published width, weights at the init's std 0.02
PRODUCTS = {"qkv": (512, 1536), "proj": (512, 512), "fc1": (512, 1024), "fc2": (1024, 512)}


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_tf32x3_matches_jax_highest(name):
    K, N = PRODUCTS[name]
    rng = np.random.RandomState(K + N)
    a = _ln_rows(rng, 64, K) if name in ("qkv", "fc1") else \
        (rng.randn(64, K) * (0.5 if name == "proj" else 0.2)).astype(np.float32)
    b = (rng.randn(K, N) * 0.02).astype(np.float32)
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                                  precision=jax.lax.Precision.HIGHEST))
    np.testing.assert_allclose(tf32x3(a, b), want, atol=2e-5, rtol=0)


# the tensor-parallel partial forms' contractions split over the ranks:
# K1-tp's and K6-tp's o @ Wp over a rank's C / tp channels, K2/K5-tp's
# GELU(h) @ W2 over its H / tp hidden units (their other products, qkv and
# fc1, keep the whole contraction over C on each rank's columns)
PARTIALS = {"proj": (512, 512), "fc2": (1024, 512)}


@pytest.mark.parametrize("tp", [2, 4, 8])
@pytest.mark.parametrize("name", list(PARTIALS))
def test_tf32x3_rank_partials_summed(name, tp):
    """Each rank's product in tf32x3 over its K / tp share of the
    contraction, the ranks' fp32 partials summed in rank order (the
    all-reduce's sum): against float64 within the larger of 4x a plain fp32
    product's error and 2e-6 at both weight scales, and against JAX's whole
    product at Precision.HIGHEST within 2e-5 at the init's scale."""
    K, N = PARTIALS[name]
    k = K // tp
    rng = np.random.RandomState(K + N + tp)
    a = (rng.randn(64, K) * (0.5 if name == "proj" else 0.2)).astype(np.float32)
    for scale in SCALES.values():
        b = (rng.randn(K, N) * scale).astype(np.float32)
        parts = [tf32x3(a[:, j * k:(j + 1) * k], b[j * k:(j + 1) * k]) for j in range(tp)]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        want = a.astype(np.float64) @ b.astype(np.float64)
        err = _rel(total, want)
        err_f32 = _rel((torch.from_numpy(a) @ torch.from_numpy(b)).numpy(), want)
        assert err <= max(4 * err_f32, 2e-6), (scale, err, err_f32)
        if scale == SCALES["weights 0.02"]:
            with jax.default_device(jax.devices("cpu")[0]):
                highest = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b),
                                             precision=jax.lax.Precision.HIGHEST))
            np.testing.assert_allclose(total, highest, atol=2e-5, rtol=0)


# The tensor cores' accumulation, as a model (test code only): a TF32
# wgmma of depth 8 adds its 8 products (exact: 11-bit significands) to the
# accumulator after aligning every term to the largest one's exponent,
# keeping TC_BITS bits of it (24 and 3 below) and truncating the rest, and
# normalises the sum toward zero. The qkv walk's first card run (fp32 K1-tp
# and K8-tp at the inputs below, with every k-step added into one
# accumulator) was 1.14e-4 off its plain version at tp = 8 and 1.58e-4 at
# tp = 2 (each the largest over the ranks); this model gives 1.18e-4 and
# 1.87e-4 on rank 0 there. With no bits below the 24 it gives less (6.6e-5
# at tp = 8), with no truncation before the last rounding more (1.3e-4).
TC_BITS = 27


def _tc_mma(acc, x, y):
    """acc (M, N) float32, or None for a fresh accumulator, plus x (M, 8) @
    y (8, N) as the model adds them."""
    p = x[:, None, :] * y.t()[None]
    t = p if acc is None else torch.cat([acc[..., None], p], -1)
    top = (t.abs().amax(-1, keepdim=True).view(torch.int32) & 0x7F800000).view(torch.float32)
    ulp = torch.where(top > 0, top * 2.0 ** (1 - TC_BITS), torch.ones_like(top)).double()
    s = torch.trunc(t.double() / ulp).sum(-1) * ulp[..., 0]
    m, e = torch.frexp(s)
    return torch.ldexp(torch.trunc(torch.ldexp(m, torch.full_like(e, 24))), e - 24).float()


def tf32x3_tc(a, b, promote=False):
    """a (M, K) @ b (K, N) in the kernels' tf32x3 order under the tensor
    cores' accumulation (`_tc_mma`): every k-step's three wgmmas into the
    output's accumulator, or, promote (`tf32x3_stage<true>`, the qkv
    walk's), each 32-k stage's twelve into a fresh one, added to the output
    in fp32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    ah, al, bh, bl = (torch.from_numpy(t) for t in (ah, al, bh, bl))
    d = torch.zeros(a.shape[0], b.shape[1])
    acc = None if promote else d
    for k in range(0, a.shape[1], 8):
        s = slice(k, k + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = _tc_mma(acc, x[:, s], y[s])
        if promote and (k + 8) % 32 == 0:
            d, acc = d + acc, None
    return (d if promote else acc).numpy()


def _rank_cols(n_parts, width, tp, j):
    per = width // tp
    return np.concatenate([np.arange(p * width + j * per, p * width + (j + 1) * per)
                           for p in range(n_parts)])


def test_tf32x3_promoted_qkv_keeps_the_tp_stage_in_band():
    """K1-tp on rank 0 of tp = 8 (one head) at the card test's inputs
    (tests/test_torch_kernels.py::test_tp_partial_forms_match_plain: 64 x
    17 unit-normal rows, weights of std 0.1, np.random.RandomState(0)):
    LN1, the qkv product under the tensor cores' accumulation, the
    attention in fp32, o @ Wp likewise (unpromoted, as the projection walk
    adds), against the stage in float64. Adding every k-step into one
    accumulator puts it past the card's fp32 band (1e-4), as on the card;
    promoting each 32-k stage brings it back inside, below half of it."""
    rng = np.random.RandomState(0)
    x, wqkv, bqkv, wp, _, ln1_s, ln1_b = _stage_inputs(rng, 64, 17, 512)[:7]
    qi, cs = _rank_cols(3, 512, 8, 0), _rank_cols(1, 512, 8, 0)
    args = (x, wqkv[:, qi], bqkv[qi], ln1_s, ln1_b, wp[cs])
    want = tattn.attention_stage_partial_plain(
        *(torch.from_numpy(np.ascontiguousarray(v)).double() for v in args), 1, 0.125, 1e-6)
    y1 = tattn.layer_norm_rows(*(torch.from_numpy(v) for v in (x, ln1_s, ln1_b)), 1e-6)
    errs = []
    for promote in (False, True):
        qkv = torch.from_numpy(tf32x3_tc(y1.reshape(-1, 512).numpy(), args[1], promote))
        qkv = (qkv + torch.from_numpy(args[2])).view(64, 17, 192)
        o = tattn._merge(tattn._stage_attend_plain(*tattn._split(qkv, 3, 1), 0.125,
                                                   torch.float32, 0, 0))
        got = tf32x3_tc(o.reshape(-1, 64).numpy(), np.ascontiguousarray(args[5]))
        errs.append(np.abs(got.reshape(want.shape) - want.numpy()).max())
    print(f"K1-tp tp=8 rank 0: unpromoted {errs[0]:.3e}, promoted {errs[1]:.3e}")
    assert errs[0] > 1e-4 and errs[1] <= 0.5e-4, errs


# The walks that add each 32-k stage from a fresh accumulator
# (`tf32x3_stage<true>`), whole and partial forms alike: qkv since its first
# card run; o @ Wp, which the card read more than half the fp32 band from
# float64 at the card tests' inputs with one accumulator over its whole K;
# fc2, without which fp32 `sample` missed its float64 truth by more than
# twice the plain composition (chip_smoke.py, phase fp32_truth, NVIDIA H100:
# 1,088 rows, `utils/fp32_accuracy.py`). fc1 stays on one accumulator.
# CARD_READ: the three readings there with one accumulator.
PROMOTED = {"qkv", "proj", "fc2"}
CARD_READ = {"proj": 9.44e-5, "fc1": 2.30e-5, "fc2": 4.93e-5}
CONTRACTIONS = ([pytest.param(n, "tp", id=n) for n in ("proj", "fc1", "fc2")]
                + [pytest.param(n, "whole", id=f"{n}-whole") for n in ("proj", "fc1", "fc2")])


@pytest.mark.parametrize("name, form", CONTRACTIONS)
def test_tf32x3_unpromoted_tp_contractions_stay_in_band(name, form):
    """The projection's, fc1's and fc2's contractions under the tensor
    cores' accumulation, on 256 rows of the card tests' inputs (o from the
    stage there; MLP rows unit normal, weights of std 0.05), against
    float64: at tp = 2 (K1-tp's and K6-tp's o @ Wp over C / 2 channels,
    K2/K5-tp's fc1 over C and fc2 over H / 2 hidden units) and whole (K1's,
    K6's, K8's and K9's o @ Wp over C = 512, K2's, K5's and K9's fc1 over C
    and fc2 over H = 1024). Promoting stages cuts the error at least
    fourfold; at tp = 2 even one accumulator stays within half the card's
    fp32 band (1e-4), and every promoted contraction does, whole or
    partial. Whole, with one accumulator the model sits at or above what
    the card read on these inputs (1,088 rows, a superset of these 256) and
    within 15% of it: pessimistic at these K; a contraction left on one
    accumulator was read within half the band."""
    from scipy.special import erf

    rng = np.random.RandomState(0)
    s = _stage_inputs(rng, 64, 17, 512)
    m = _mlp_inputs(rng, 64, 17, 1, 512, 1024)
    k, hid = (512, 1024) if form == "whole" else (256, 512)
    if name == "proj":
        x, ln1_s, ln1_b = (torch.from_numpy(v) for v in (s[0], s[5], s[6]))
        qkv = tattn.layer_norm_rows(x, ln1_s, ln1_b, 1e-6) @ torch.from_numpy(s[1])
        o = tattn._merge(tattn._stage_attend_plain(
            *tattn._split((qkv + torch.from_numpy(s[2])).view(64, 17, -1), 3, 8), 0.125,
            torch.float32, 0, 0)).reshape(-1, 512).numpy()
        a, b = o[:256, :k], s[3][:k]
    else:
        xm = m[0].reshape(-1, 512)[:256]
        if name == "fc1":
            a, b = xm, m[2][:, :hid]
        else:
            h = xm.astype(np.float64) @ m[2][:, :hid] + m[3][:hid]
            a, b = (0.5 * h * (1 + erf(h / np.sqrt(2)))).astype(np.float32), m[4][:hid]
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    want = a.astype(np.float64) @ b.astype(np.float64)
    errs = [np.abs(tf32x3_tc(a, b, promote) - want).max() for promote in (False, True)]
    print(f"{name} {form} K={a.shape[1]} |out| <= {np.abs(want).max():.2f}: unpromoted "
          f"{errs[0]:.3e}, promoted {errs[1]:.3e}")
    assert errs[1] <= errs[0] / 4, errs
    if form == "tp":
        assert errs[0] <= 0.5e-4, errs
    else:
        assert CARD_READ[name] <= errs[0] <= 1.15 * CARD_READ[name], errs
    if name in PROMOTED:
        assert errs[1] <= 0.5e-4, errs
    else:
        assert CARD_READ[name] <= 0.5e-4


def test_selectors_read_the_partial_walks_operands():
    """`utils.fp32_accuracy`, which reads the fp32 walks against float64 on
    the card, on the CPU, where the partial forms run their plain versions:
    on a selector they return each contraction's operand exactly (the
    attention output, fc1's pre-activations + b1 under nogelu, the GELU
    outputs, C hidden units a call), and the readings put the forms' fp32
    products within fp32 rounding of float64, equal to the plain product's
    on the same operands."""
    import torch.nn.functional as Fn

    from d3dp_tpu_torch.utils import fp32_accuracy as fa

    g = torch.Generator().manual_seed(0)
    R, N, C, H, heads = 3, 17, 128, 256, 2
    qkv = torch.randn(R, N, 3 * C, generator=g)
    y = torch.randn(R * N, C, generator=g)
    wp, w1, w2 = (torch.randn(*shape, generator=g) * 0.05 for shape in ((C, C), (C, H), (H, C)))
    b1 = torch.randn(H, generator=g) * 0.02
    torch.testing.assert_close(fa.proj_operand(qkv, heads, 0.125),
                               tattn.fused_attention_qkv_plain(qkv, heads, 0.125), rtol=0, atol=0)
    torch.testing.assert_close(fa.mlp_operand(y, w1, b1, "nogelu"), y @ w1 + b1, rtol=0, atol=0)
    torch.testing.assert_close(fa.mlp_operand(y, w1, b1), Fn.gelu(y @ w1 + b1), rtol=0, atol=0)
    readings = fa.contraction_errors(qkv, wp, y, w1, b1, w2, heads, 0.125)
    assert set(readings) == {"proj", "fc1", "fc2"}
    for name, r in readings.items():
        assert r["K"] == (H if name == "fc2" else C)
        assert r["kernel"] <= 1e-6 * r["out"] and r["plain"] <= 1e-6 * r["out"], (name, r)
        assert r["kernel"] == pytest.approx(r["plain"], rel=0.5, abs=1e-7), (name, r)


def _step(model, seed):
    """One AdamW step on the model's parameters from a random loss."""
    opt = make_optimizer(model.parameters(), 1e-3)
    g = torch.Generator().manual_seed(seed)
    x2d = torch.randn(2, 9, 17, 2, generator=g)
    x3d = torch.randn(2, 9, 17, 3, generator=g)
    loss = model(x2d, x3d, torch.tensor([3, 7]), train=True).square().mean()
    loss.backward()
    opt.step()


def _carried(W):
    """Every matrix of the weight cache W that the fp32 kernels take, with
    its planes there: each kind's stacks (`resident_planes`), each block's
    views and its head-major qkv (`planes`)."""
    rp = W["resident_planes"]
    out = [(stacked[k], rp and rp[i][j]) for i, stacked in enumerate(W["resident"][:2])
           for j, k in enumerate((0, 2, 3, 5))]
    for blk in W["ste"] + W["tte"]:
        p = blk["planes"]
        stage, mlp, hm = (p[k] or (None, None) for k in ("stage", "mlp", "hm"))
        out += [(blk["wqkv"], stage[0]), (blk["wp"], stage[1]), (blk["w1"], mlp[0]),
                (blk["w2"], mlp[1]), (blk["hm"][0], hm[0])]
        assert p["block"] is None or p["block"][0] is p["stage"][1]
        assert p["hm"] is None or p["hm"][1] is p["stage"][1]
    return out


def _assert_fresh(W):
    """Every matrix of W comes with the planes of its current value."""
    for m, p in _carried(W):
        assert p is not None and torch.equal(p, tf32.planes(m))


def test_weight_cache_makes_planes_once_per_weight_version():
    """fp32: the cache holds every matrix's planes (the blocks' views of the
    stacks' planes), the same while the weights stand, and new ones after
    an optimizer step."""
    model = MixSTE2(MixSTEConfig(**SMALL, fuse_level=4), device="cpu")
    W = model._weights()
    _assert_fresh(W)
    for m, p in _carried(W):
        err = (p[..., 0, :, :] + p[..., 1, :, :]).double() - m.transpose(-1, -2).double()
        assert (err.abs() <= 2.0 ** -22 * m.transpose(-1, -2).abs()).all()
    spatial = W["ste"][1]["planes"]["stage"][0]
    assert spatial.data_ptr() == W["resident_planes"][0][0][1].data_ptr()
    assert model._weights() is W

    before = [p.clone() for _, p in _carried(W)]
    _step(model, 5)
    W2 = model._weights()
    assert W2 is not W
    _assert_fresh(W2)
    assert not any(torch.equal(a, b) for a, (_, b) in zip(before, _carried(W2)))


EDITS = ("in place", "in place under inference_mode", "data swap")


@pytest.mark.parametrize("edit", EDITS)
def test_weight_cache_planes_follow_every_weight_edit(edit):
    """An edit of a weight that no optimizer made: the next `_weights()`
    (as `D3DP.sample` builds it, under torch.inference_mode) holds the
    planes of the new value, never the old ones."""
    model = MixSTE2(MixSTEConfig(**SMALL, fuse_level=4), device="cpu")
    with torch.inference_mode():
        old = model._weights()["ste"][0]["planes"]["stage"][0].clone()
    w = model.STEblocks[0].attn.qkv.weight
    if edit == "data swap":
        w.data = w.data * 2.0
    elif edit == "in place":
        with torch.no_grad():
            w.mul_(2.0)
    else:
        with torch.inference_mode():
            w.mul_(2.0)
    with torch.inference_mode():
        W = model._weights()
    _assert_fresh(W)
    assert not torch.equal(W["ste"][0]["planes"]["stage"][0], old)


@pytest.mark.parametrize("level", [2, 4, 5])
def test_model_passes_the_cache_planes_to_the_ops(monkeypatch, level):
    """The fused eval flow hands each fp32 op the cache's planes of the
    weights it passes (levels 2, 4 and 5: the block, the stage and the MLP
    ops, the depth-resident op)."""
    from d3dp_tpu_torch.ops import attention, mlp, resident

    # one head of 64 channels: the kernels' head width
    model = MixSTE2(MixSTEConfig(**dict(SMALL, num_heads=1), fuse_level=level), device="cpu")
    W = model._weights()
    seen = []

    def spy(mod, name, mats):
        f = getattr(mod, name)

        def wrapped(*a, planes=None, **k):
            seen.append(name)
            assert planes is not None
            for i, p in zip(mats, planes):
                assert p is None or torch.equal(p, tf32.planes(a[i]))
            return f(*a, planes=planes, **k)
        monkeypatch.setattr(mod, name, wrapped)

    spy(attention, "attention_stage", (1, 3))
    spy(attention, "attention_block", (2,))
    spy(mlp, "mlp_block_t", (2, 4))
    spy(mlp, "mlp_block", (2, 4))
    spy(resident, "resident_block_stack", ())
    g = torch.Generator().manual_seed(0)
    x2d = torch.randn(2, 9, 17, 2, generator=g)
    x3d = torch.randn(2, 9, 17, 3, generator=g)
    with torch.inference_mode():
        model(x2d, x3d, torch.tensor([3, 7]))
    want = {2: {"attention_block", "mlp_block"}, 4: {"attention_stage", "mlp_block_t"},
            5: {"resident_block_stack"}}[level]
    assert set(seen) == want
    if level == 5:
        assert W["resident_planes"] is not None


def test_weight_cache_has_no_planes_in_bf16():
    model = MixSTE2(MixSTEConfig(**SMALL, fuse_level=4, dtype=torch.bfloat16), device="cpu")
    assert all(p is None for _, p in _carried(model._weights()))


# The block linears' GEMM (`ops.linear`, csrc/linear_tf32x3.cu) promotes
# every 32-k stage, at the training step's contractions: K = 512 (qkv,
# proj, fc1 forward; proj's and fc2's input gradients), 1024 (fc2 forward,
# fc1's input gradient), 1536 (qkv's input gradient).
@pytest.mark.parametrize("orient", ["forward", "input gradient"])
@pytest.mark.parametrize("K", [512, 1024, 1536])
def test_tf32x3_gemm_promotion_holds_fp32_accuracy_over_k(K, orient):
    """Under the tensor cores' accumulation model, 128 rows x 128 columns
    (LayerNorm outputs times weights of the init's std forward, gradients
    of 1e-3 times them backward): one accumulator over K drifts past twice
    a plain fp32 product's error from float64 (the card test's limit
    against cuBLAS), growing with K; promoting each 32-k stage keeps the
    GEMM within it at every K."""
    rng = np.random.RandomState(K)
    a = _ln_rows(rng, 128, K) if orient == "forward" else \
        (rng.randn(128, K) * 1e-3).astype(np.float32)
    b = (rng.randn(K, 128) * 0.02).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    err_f32 = _rel((torch.from_numpy(a) @ torch.from_numpy(b)).numpy(), want)
    one, promoted = (_rel(tf32x3_tc(a, b, p), want) for p in (False, True))
    print(f"K={K} {orient}: one accumulator {one:.3e}, promoted {promoted:.3e}, "
          f"fp32 {err_f32:.3e}")
    assert promoted <= 2 * err_f32 < one, (promoted, err_f32, one)

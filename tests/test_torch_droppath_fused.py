"""The `D3DP_TRAIN_FUSED=1` training path against the JAX package's, on the
CPU.

Op level: the DropPath forms of the stage and MLP ops (`attention_stage_dp`,
`mlp_block_dp`, `mlp_block_t_dp`) and the fused ops' autograd Functions
(`*_ad`), plain torch versions here, against the JAX custom-VJP ops run in
interpret mode: forward 2e-5, gradients 2e-4 (the tolerances of
tests/test_droppath_fused.py), fp32; each Function's backward also against
torch.autograd through its plain forward. Model level: with
`D3DP_TRAIN_FUSED=1`, the port's training forward, loss and every gradient
at fuse levels 1-5 against `jax.value_and_grad` of JAX `pallas` at the same
level, with the same weights, t, noise and DropPath masks injected (loss
2e-4 relative, gradients 2e-4), and the route each block takes. The CUDA
kernels are held against the plain versions on the card in
tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3dp_tpu.models import MixSTEConfig as JMixSTEConfig
from d3dp_tpu.ops import attention as jattn
from d3dp_tpu.ops import mlp as jmlp
from d3dp_tpu.ops.norm import _ln_bwd_rows
from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.ops import mlp as tmlp
from d3dp_tpu_torch.ops.norm import ln_bwd_rows
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from tests.test_torch_kernels import _mlp_inputs, _stage_inputs
from tests.test_torch_model import SMALL, random_params
from tests.test_torch_train import (_batch, _droppath_masks, _jax_loss_and_grads,
                                    _port_loss_and_grads)

torch.set_num_threads(1)

FWD, GRAD = 2e-5, 2e-4


def _dp(rng, shape, keep=0.9):
    """DropPath scales: 0 where dropped, 1/keep where kept, at least one of
    each."""
    m = np.where(rng.rand(*shape) < keep, 1.0 / keep, 0.0).astype(np.float32)
    m.flat[0], m.flat[-1] = 0.0, 1.0 / keep
    return m


def _leaves(arrs):
    """Torch leaves that need gradients, fp32 (the compared inputs)."""
    return [torch.from_numpy(a).requires_grad_(True) for a in arrs]


def _torch_vjp(fn, arrs, cts):
    """(outputs, gradients of sum(out * ct) for every input) through torch
    autograd."""
    leaves = _leaves(arrs)
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, leaves, [torch.from_numpy(c) for c in cts])
    return [o.detach().numpy() for o in outs], [g.numpy() for g in grads]


def _jax_vjp(fn, arrs, cts):
    outs, vjp = jax.vjp(fn, *[jnp.asarray(a) for a in arrs])
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = vjp(tuple(jnp.asarray(c) for c in cts) if len(cts) > 1 else jnp.asarray(cts[0]))
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


def _assert_vjp_close(got, want, names):
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, atol=FWD, rtol=0)
    for g, w, name in zip(got[1], want[1], names):
        np.testing.assert_allclose(g, w, atol=GRAD, rtol=0, err_msg=name)


STAGE_NAMES = ("x", "wqkv", "bqkv", "wp", "bp", "ln1_s", "ln1_b", "ln2_s", "ln2_b")
MLP_NAMES = ("x", "res", "w1", "b1", "w2", "b2", "ln_s", "ln_b")


# ------------------------------------------------------------------- ops
@pytest.mark.parametrize("dp", [False, True])
@pytest.mark.parametrize("N", [17, 128])
def test_attention_stage_ad_matches_jax(rng, N, dp):
    """`attention_stage_ad` / `attention_stage_dp_ad` against JAX
    `attention_stage_p` / `attention_stage_dp_p` (N=128: the temporal
    stage's default `batched` variant on the JAX side), forward and the VJP
    of random cotangents for x2 and y2."""
    R, C, h = 4, 64, 4
    args = _stage_inputs(rng, R, N, C)
    cts = [rng.randn(R, N, C).astype(np.float32) for _ in range(2)]
    if dp:
        s = _dp(rng, (R,))
        got = _torch_vjp(lambda *a: tattn.attention_stage_dp_ad(
            *a, torch.from_numpy(s), h, 0.125, 1e-6), args, cts)
        want = _jax_vjp(lambda *a: jattn.attention_stage_dp_p(*a, jnp.asarray(s), h, 0.125,
                                                              1e-6), args, cts)
    else:
        got = _torch_vjp(lambda *a: tattn.attention_stage_ad(*a, h, 0.125, 1e-6), args, cts)
        want = _jax_vjp(lambda *a: jattn.attention_stage_p(*a, h, 0.125, 1e-6), args, cts)
    _assert_vjp_close(got, want, STAGE_NAMES)


def test_attention_block_ad_matches_jax(rng):
    R, N, C, h = 3, 17, 64, 4
    arrs = [rng.randn(R, N, 3 * C).astype(np.float32), rng.randn(R, N, C).astype(np.float32),
            (rng.randn(C, C) * 0.1).astype(np.float32), (rng.randn(C) * 0.05).astype(np.float32),
            (1 + 0.1 * rng.randn(C)).astype(np.float32), (0.1 * rng.randn(C)).astype(np.float32)]
    cts = [rng.randn(R, N, C).astype(np.float32) for _ in range(2)]
    got = _torch_vjp(lambda *a: tattn.attention_block_ad(*a, h, 0.125, 1e-6), arrs, cts)
    want = _jax_vjp(lambda *a: jattn.attention_block_p(*a, h, 0.125, 1e-6), arrs, cts)
    _assert_vjp_close(got, want, ("qkv", "res", "w", "b", "ln_s", "ln_b"))


@pytest.mark.parametrize("dp", [False, True])
def test_mlp_block_ad_matches_jax(rng, dp):
    """The rows form, one DropPath scale per row."""
    R, C, H = 37, 64, 128
    args = _mlp_inputs(rng, 1, R, 1, C, H)
    args[:2] = [a.reshape(R, C) for a in args[:2]]
    cts = [rng.randn(R, C).astype(np.float32)]
    if dp:
        s = _dp(rng, (R,))
        got = _torch_vjp(lambda *a: tmlp.mlp_block_dp_ad(*a, torch.from_numpy(s), 1e-6),
                         args, cts)
        want = _jax_vjp(lambda *a: jmlp.mlp_block_dp_p(*a, jnp.asarray(s), 1e-6), args, cts)
    else:
        got = _torch_vjp(lambda *a: tmlp.mlp_block_ad(*a, 1e-6), args, cts)
        want = _jax_vjp(lambda *a: jmlp.mlp_block_p(*a, 1e-6), args, cts)
    _assert_vjp_close(got, want, MLP_NAMES)


@pytest.mark.parametrize("dp", [False, True])
@pytest.mark.parametrize("shape", [(2, 150, 5), (2, 5, 150)])
def test_mlp_block_t_ad_matches_jax(rng, shape, dp):
    """The transposing form, one DropPath scale per (b, i) of (B, D1);
    150 frames leave a partial last 128-frame tile on the JAX side."""
    B, D1, D2 = shape
    C, H = 64, 128
    args = _mlp_inputs(rng, *shape, C, H)
    cts = [rng.randn(B, D2, D1, C).astype(np.float32)]
    if dp:
        s = _dp(rng, (B, D1))
        got = _torch_vjp(lambda *a: tmlp.mlp_block_t_dp_ad(*a, torch.from_numpy(s), 1e-6),
                         args, cts)
        want = _jax_vjp(lambda *a: jmlp.mlp_block_t_dp_p(*a, jnp.asarray(s), 1e-6), args, cts)
    else:
        got = _torch_vjp(lambda *a: tmlp.mlp_block_t_ad(*a, 1e-6), args, cts)
        want = _jax_vjp(lambda *a: jmlp.mlp_block_t_p(*a, 1e-6), args, cts)
    _assert_vjp_close(got, want, MLP_NAMES)


def test_dp_forms_with_unit_scales_are_the_plain_ops(rng):
    """dp = 1 everywhere computes the op without DropPath, bit for bit; a
    dropped row's branch vanishes (x2 = x)."""
    R, N, C, h = 3, 17, 64, 4
    sargs = [torch.from_numpy(a) for a in _stage_inputs(rng, R, N, C)]
    ones = torch.ones(R)
    for a, b in zip(tattn.attention_stage_dp(*sargs, ones, h, 0.125, 1e-6),
                    tattn.attention_stage(*sargs, h, 0.125, 1e-6)):
        assert torch.equal(a, b)
    x2, _ = tattn.attention_stage_dp(*sargs, torch.tensor([0.0, 1.0, 2.0]), h, 0.125, 1e-6)
    assert torch.equal(x2[0], sargs[0][0])
    margs = [torch.from_numpy(a) for a in _mlp_inputs(rng, 2, 9, 17, C, 128)]
    assert torch.equal(tmlp.mlp_block_t_dp(*margs, torch.ones(2, 9), 1e-6),
                       tmlp.mlp_block_t(*margs, 1e-6))
    rows = [m.reshape(-1, C) for m in margs[:2]] + margs[2:]
    assert torch.equal(tmlp.mlp_block_dp(*rows, torch.ones(rows[0].shape[0]), 1e-6),
                       tmlp.mlp_block(*rows, 1e-6))


def _plain_stage(*a, dp=None):
    return tattn.attention_stage_plain(*a, 4, 0.125, 1e-6, dp_row=dp)


@pytest.mark.parametrize("which", ["stage", "stage_dp", "block", "mlp_dp", "mlp_t_dp"])
def test_backward_matches_autograd_of_the_plain_forward(rng, which):
    """Each Function's custom backward against torch.autograd through its
    plain forward, fp32 (the card's check, here on the plain versions)."""
    R, N, C, H = 3, 17, 64, 128
    if which.startswith("stage"):
        arrs = _stage_inputs(rng, R, N, C)
        s = torch.from_numpy(_dp(rng, (R,))) if which == "stage_dp" else None
        fused = (lambda *a: tattn.attention_stage_dp_ad(*a, s, 4, 0.125, 1e-6)) if s is not None \
            else (lambda *a: tattn.attention_stage_ad(*a, 4, 0.125, 1e-6))
        plain = lambda *a: _plain_stage(*a, dp=s)  # noqa: E731
        cts = [rng.randn(R, N, C).astype(np.float32) for _ in range(2)]
    elif which == "block":
        arrs = [rng.randn(R, N, 3 * C).astype(np.float32), rng.randn(R, N, C).astype(np.float32),
                (rng.randn(C, C) * 0.1).astype(np.float32),
                (rng.randn(C) * 0.05).astype(np.float32),
                (1 + 0.1 * rng.randn(C)).astype(np.float32),
                (0.1 * rng.randn(C)).astype(np.float32)]
        fused = lambda *a: tattn.attention_block_ad(*a, 4, 0.125, 1e-6)  # noqa: E731
        plain = lambda *a: tattn.attention_block_plain(*a, 4, 0.125, 1e-6)  # noqa: E731
        cts = [rng.randn(R, N, C).astype(np.float32) for _ in range(2)]
    elif which == "mlp_dp":
        arrs = _mlp_inputs(rng, 1, R * N, 1, C, H)
        arrs[:2] = [a.reshape(R * N, C) for a in arrs[:2]]
        s = torch.from_numpy(_dp(rng, (R * N,)))
        fused = lambda *a: tmlp.mlp_block_dp_ad(*a, s, 1e-6)  # noqa: E731
        plain = lambda *a: tmlp.mlp_block_dp_plain(*a, s, 1e-6)  # noqa: E731
        cts = [rng.randn(R * N, C).astype(np.float32)]
    else:
        arrs = _mlp_inputs(rng, 2, 9, 17, C, H)
        s = torch.from_numpy(_dp(rng, (2, 9)))
        fused = lambda *a: tmlp.mlp_block_t_dp_ad(*a, s, 1e-6)  # noqa: E731
        plain = lambda *a: tmlp.mlp_block_t_dp_plain(*a, s, 1e-6)  # noqa: E731
        cts = [rng.randn(2, 17, 9, C).astype(np.float32)]
    got, want = _torch_vjp(fused, arrs, cts), _torch_vjp(plain, arrs, cts)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, atol=GRAD, rtol=0)


def test_ln_bwd_rows_matches_jax(rng):
    s = rng.randn(40, 64).astype(np.float32) * 3 + 1
    scale = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    g = rng.randn(40, 64).astype(np.float32)
    want = _ln_bwd_rows(jnp.asarray(s), jnp.asarray(scale), jnp.asarray(g), 1e-6)
    got = ln_bwd_rows(torch.from_numpy(s), torch.from_numpy(scale), torch.from_numpy(g), 1e-6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-6)


# ----------------------------------------------------------------- model
# which fused op each block takes at fuse level L with D3DP_TRAIN_FUSED=1,
# at depth 2 with DropPath 0.1 (block 0 of each kind has rate 0)
ROUTES = {1: {"mlp_block_ad": 2}, 2: {"attention_block_ad": 2, "mlp_block_ad": 2},
          3: {"attention_block_ad": 2, "mlp_block_t_ad": 2},
          4: {"attention_stage_ad": 2, "attention_stage_dp_ad": 2, "mlp_block_t_ad": 2,
              "mlp_block_t_dp_ad": 2}}
ROUTES[5] = ROUTES[4]


def _count_routes(monkeypatch):
    """Wrap every fused autograd op the model can call; returns the call
    counts."""
    calls = {}
    for mod, names in ((tattn, ("attention_stage_ad", "attention_stage_dp_ad",
                                "attention_block_ad")),
                       (tmlp, ("mlp_block_ad", "mlp_block_dp_ad", "mlp_block_t_ad",
                               "mlp_block_t_dp_ad"))):
        for name in names:
            def wrap(*a, _f=getattr(mod, name), _n=name, **k):
                calls[_n] = calls.get(_n, 0) + 1
                return _f(*a, **k)
            monkeypatch.setattr(mod, name, wrap)
    return calls


@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_train_fused_loss_and_grads_match_jax(level, monkeypatch):
    """fp32, DropPath 0.1 with the port's masks injected on both sides: the
    fused training flow at `level` against JAX pallas at that level under
    the same switch; each block on the route JAX takes (a block with active
    DropPath composed at levels 1-3; every block fused at 4 and 5)."""
    monkeypatch.setenv("D3DP_TRAIN_FUSED", "1")
    cfg = dict(SMALL, drop_path_rate=0.1, fuse_level=level)
    params = random_params(JMixSTEConfig(**SMALL), seed=3)
    batch = _batch(4)
    masks = _droppath_masks(cfg, 5)
    jloss, jgrads = _jax_loss_and_grads(params, cfg, "pallas", batch, masks, monkeypatch)
    calls = _count_routes(monkeypatch)
    tloss, tgrads = _port_loss_and_grads(params, cfg, batch, masks)
    assert calls == ROUTES[level]
    want = state_dict_from_flax(jgrads, cfg["depth"])
    assert set(tgrads) == set(want)
    assert abs(tloss - jloss) <= 2e-4 * abs(jloss)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g, want[name].numpy(), atol=GRAD, rtol=0, err_msg=name)


@pytest.mark.parametrize("switch", ["0", None])
def test_train_fused_switch_off_keeps_the_composed_path(switch, monkeypatch):
    """Without D3DP_TRAIN_FUSED=1 (and at fuse level 0 with it) training
    takes no fused op."""
    if switch is None:
        monkeypatch.delenv("D3DP_TRAIN_FUSED", raising=False)
    else:
        monkeypatch.setenv("D3DP_TRAIN_FUSED", switch)
    calls = _count_routes(monkeypatch)
    params = random_params(JMixSTEConfig(**SMALL), seed=3)
    masks = _droppath_masks(dict(SMALL, drop_path_rate=0.1), 5)
    _port_loss_and_grads(params, dict(SMALL, drop_path_rate=0.1, fuse_level=4), _batch(4), masks)
    monkeypatch.setenv("D3DP_TRAIN_FUSED", "1")
    _port_loss_and_grads(params, dict(SMALL, drop_path_rate=0.1, fuse_level=0), _batch(4), masks)
    assert calls == {}


def test_train_fused_bf16_runs_and_points_like_fp32(monkeypatch):
    """bf16 compute at level 4: finite loss, and every gradient within
    cosine 0.99 of the fused fp32 gradient (bf16 rounds the backward's
    operands; the JAX bf16 comparison is the composed path's, in
    tests/test_torch_train.py)."""
    monkeypatch.setenv("D3DP_TRAIN_FUSED", "1")
    cfg = dict(SMALL, drop_path_rate=0.1, fuse_level=4)
    params = random_params(JMixSTEConfig(**SMALL), seed=3)
    masks = _droppath_masks(cfg, 5)
    l16, g16 = _port_loss_and_grads(params, cfg, _batch(6), masks, dtype=torch.bfloat16)
    l32, g32 = _port_loss_and_grads(params, cfg, _batch(6), masks)
    assert np.isfinite(l16) and abs(l16 - l32) <= 2e-2 * abs(l32)
    for name, g in g16.items():
        a, b = np.ravel(g).astype(np.float64), np.ravel(g32[name]).astype(np.float64)
        assert a @ b >= 0.99 * np.linalg.norm(a) * np.linalg.norm(b), name

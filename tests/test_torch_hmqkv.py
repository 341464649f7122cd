"""The attention-stage lab switches and the head-major stage (K8) against
the JAX package, on the CPU.

The JAX package reads `D3DP_ATTN_VARIANT[_T|_S]`, `D3DP_SPATIAL_GROUP`,
`D3DP_SOFTMAX_FOLD` and `D3DP_MLP_VARIANT` when it traces a kernel; the port
reads them when an op is called. `hmqkv` runs the head-major stage, every
other variant the stage kernel with the options the JAX package's
resolution gives it (tests/test_torch_lab_switches.py holds the rest of
them). The JAX kernels read the switches at trace time, so the tests that
set one drop JAX's compilation caches around it.

Tolerances: K8's plain version against `_attention_stage_fwd` under hmqkv
(interpret mode) as K1's, fp32 2e-5 and bf16 3e-2 plus one bf16 ulp
(tests/test_torch_ops.py), 5e-2 for bf16exp in bf16 (the JAX suite's band,
tests/test_pallas_ops.py:196); MixSTE2 under a switch against JAX 1e-4;
the fused training flow with hmqkv 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3dp_tpu.models import MixSTE2 as JMixSTE2, MixSTEConfig as JMixSTEConfig
from d3dp_tpu.ops.attention import _attention_stage_fwd
from d3dp_tpu.ops.mlp import _mlp_block_fwd
from d3dp_tpu_torch.models import MixSTE2
from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.ops import mlp as tmlp
from d3dp_tpu_torch.ops import resident as tres
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from tests.test_torch_kernels import _excess, _mlp_inputs, _stage_inputs, _t
from tests.test_torch_model import SMALL, port_model, random_params
from tests.test_torch_ops import DTYPES, _assert_close, _jax_args
from tests.test_torch_train import (_batch, _droppath_masks, _jax_loss_and_grads,
                                    _port_loss_and_grads)

torch.set_num_threads(1)

SWITCHES = ("D3DP_ATTN_VARIANT", "D3DP_ATTN_VARIANT_T", "D3DP_ATTN_VARIANT_S",
            "D3DP_SPATIAL_GROUP", "D3DP_SOFTMAX_FOLD", "D3DP_MLP_VARIANT", "D3DP_TRAIN_FUSED")


@pytest.fixture
def env(monkeypatch):
    """monkeypatch with every switch unset and JAX's caches dropped before
    and after, so no trace made under another setting is reused."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    jax.clear_caches()
    yield monkeypatch
    monkeypatch.undo()
    jax.clear_caches()


def _stage_args(rng, R=4, N=17, C=128, dtype=torch.float32):
    arrs = _stage_inputs(rng, R, N, C)
    return arrs, _t(arrs, dtype=dtype)


# ------------------------------------------------------- variant resolution
@pytest.mark.parametrize("n_tokens,setting,want", [
    (243, {}, "batched"), (17, {}, ""),
    (243, {"D3DP_ATTN_VARIANT": "hmqkv"}, "hmqkv"),
    (17, {"D3DP_ATTN_VARIANT": "hmqkv", "D3DP_ATTN_VARIANT_S": ""}, ""),
    (243, {"D3DP_ATTN_VARIANT": "hmqkv", "D3DP_ATTN_VARIANT_T": "loop"}, "loop"),
    (128, {"D3DP_ATTN_VARIANT_S": "hmqkv"}, "batched"),
    (127, {"D3DP_ATTN_VARIANT_S": "hmqkv"}, "hmqkv")])
def test_stage_variant_resolves_as_jax(env, n_tokens, setting, want):
    from d3dp_tpu.ops.attention import _stage_variant

    for k, v in setting.items():
        env.setenv(k, v)
    assert tattn.stage_variant(n_tokens) == _stage_variant(n_tokens) == want


@pytest.mark.parametrize("variant", ["", "loop", "batched"])
def test_production_variants_run_the_stage(env, rng, variant):
    env.setenv("D3DP_ATTN_VARIANT", variant)
    _, args = _stage_args(rng)
    for a, b in zip(tattn.attention_stage(*args, 2, 0.125, 1e-6),
                    tattn.attention_stage_plain(*args, 2, 0.125, 1e-6)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("variant", ["bf16exp", "pipelined", "phasesplit", "noy2", "other"])
def test_unported_stage_variants_raise(env, rng, variant):
    """Each variant runs the stage kernel's math that the JAX kernel runs
    under it, on the spatial and the temporal stage, in both dtypes, and so
    does the DropPath form (which keeps bf16exp and runs noy2 and unknown
    values as production): against `_attention_stage_fwd` under the same
    switch. noy2 writes x2 alone, equal to the production x2 bit for bit."""
    env.setenv("D3DP_ATTN_VARIANT", variant)
    for N in (17, 130):
        for dt in (torch.float32, torch.bfloat16):
            arrs, args = _stage_args(rng, R=2, N=N, dtype=dt)
            dp = torch.tensor([0.0, 1.0 / 0.9])
            jargs = _jax_args(arrs, DTYPES[dt])
            want = _attention_stage_fwd(*jargs, 2, 0.125, 1e-6, interpret=True)
            want_dp = _attention_stage_fwd(*jargs, 2, 0.125, 1e-6, interpret=True,
                                           dp_row=jnp.asarray(dp.numpy()))
            got = tattn.attention_stage(*args, 2, 0.125, 1e-6)
            got_dp = tattn.attention_stage_dp(*args, dp, 2, 0.125, 1e-6)
            band = {torch.bfloat16: (5e-2, 0.0)} if variant == "bf16exp" else None
            n_out = 1 if variant == "noy2" else 2
            for g, w in list(zip(got, want))[:n_out] + list(zip(got_dp, want_dp)):
                if band and dt == torch.bfloat16:
                    w32 = torch.from_numpy(np.array(w.astype(jnp.float32)))
                    assert _excess(g, w32, dt, band) <= 0
                else:
                    _assert_close(g, w, dt)
            if variant == "noy2":
                assert torch.equal(got[0], tattn.attention_stage_plain(*args, 2, 0.125, 1e-6)[0])


@pytest.mark.parametrize("g", [2, 4, 8])
def test_spatial_group_and_softmax_fold_raise_where_jax_changes_the_math(env, rng, g):
    """D3DP_SPATIAL_GROUP=g groups a stage of N <= 32 tokens whose rows
    divide by g (JAX `_attention_stage_fwd`), here into folds of 17g = 34,
    68 and 136 tokens (past one 64-query block from g = 4): the masked stage
    against JAX grouped (2e-5) and the ungrouped stage (1e-5), and JAX
    grouped against the port's ungrouped plain stage (2e-5), the identity
    under the fp32 grouped kernel, which runs each folded sequence alone
    (JAX's -1e30 block mask gives every other key p = 0 exactly); 3 rows do
    not group. D3DP_SOFTMAX_FOLD=0 changes the bf16 order only: fp32 is the
    production stage bit for bit, bf16 the JAX kernel's order at K1's
    band."""
    arrs, args = _stage_args(rng, R=2 * g, N=17)
    ungrouped = tattn.attention_stage(*args, 2, 0.125, 1e-6)
    env.setenv("D3DP_SPATIAL_GROUP", str(g))
    assert tattn.stage_config(args[0]) == ("packed", 0, g)
    want = _attention_stage_fwd(*_jax_args(arrs, jnp.float32), 2, 0.125, 1e-6, interpret=True)
    got = tattn.attention_stage(*args, 2, 0.125, 1e-6)
    for gv, w, u in zip(got, want, ungrouped):
        _assert_close(gv, w, torch.float32)
        _assert_close(u, w, torch.float32)
        torch.testing.assert_close(gv, u, atol=1e-5, rtol=0)
    _, odd = _stage_args(rng, R=3, N=17)
    for a, b in zip(tattn.attention_stage(*odd, 2, 0.125, 1e-6),
                    tattn.attention_stage_plain(*odd, 2, 0.125, 1e-6)):
        assert torch.equal(a, b)  # 3 rows: JAX does not group
    env.setenv("D3DP_SPATIAL_GROUP", "1")
    env.setenv("D3DP_SOFTMAX_FOLD", "0")
    jax.clear_caches()
    for a, b in zip(tattn.attention_stage(*args, 2, 0.125, 1e-6), ungrouped):
        assert torch.equal(a, b)
    arrs16, args16 = _stage_args(rng, R=4, N=17, dtype=torch.bfloat16)
    want16 = _attention_stage_fwd(*_jax_args(arrs16, jnp.bfloat16), 2, 0.125, 1e-6,
                                  interpret=True)
    for gv, w in zip(tattn.attention_stage(*args16, 2, 0.125, 1e-6), want16):
        _assert_close(gv, w, torch.bfloat16)


def test_mlp_variant_nogelu_is_other_math_and_raises(env, rng):
    """Under D3DP_MLP_VARIANT=nogelu the JAX MLP op drops the GELU (other
    math than the plain GELU version), and so do the port's four MLP ops,
    against the JAX kernels (2e-5); bf16gelu in fp32 is the exact GELU in
    both packages."""
    C, H = 64, 128
    arrs = _mlp_inputs(rng, 1, 23, 1, C, H)
    arrs[:2] = [a.reshape(23, C) for a in arrs[:2]]
    targs = _t(arrs)
    jargs = _jax_args(arrs, jnp.float32)
    plain = tmlp.mlp_block_plain(*targs, 1e-6).numpy()
    np.testing.assert_allclose(
        np.asarray(_mlp_block_fwd(*jargs, 1e-6, interpret=True)), plain, atol=2e-5)
    env.setenv("D3DP_MLP_VARIANT", "nogelu")
    jax.clear_caches()
    nogelu = np.asarray(_mlp_block_fwd(*jargs, 1e-6, interpret=True))
    assert np.abs(nogelu - plain).max() > 1e-2
    mrows = targs[:8]
    m4 = [a.reshape(1, 23, 1, C) if a.dim() == 2 and a.shape[0] == 23 else a for a in mrows]
    ones = torch.ones(23)
    for got in (tmlp.mlp_block(*mrows, 1e-6), tmlp.mlp_block_dp(*mrows, ones, 1e-6),
                tmlp.mlp_block_t(*m4, 1e-6).reshape(23, C),
                tmlp.mlp_block_t_dp(*m4, ones.view(1, 23), 1e-6).reshape(23, C)):
        np.testing.assert_allclose(got.numpy(), nogelu, atol=2e-5)
    env.setenv("D3DP_MLP_VARIANT", "bf16gelu")
    jax.clear_caches()
    np.testing.assert_allclose(
        np.asarray(_mlp_block_fwd(*jargs, 1e-6, interpret=True)), plain, atol=2e-5)
    assert torch.equal(tmlp.mlp_block(*mrows, 1e-6), torch.from_numpy(plain))


@pytest.mark.parametrize("level,setting", [
    (4, ("D3DP_ATTN_VARIANT", "pipelined")), (3, ("D3DP_MLP_VARIANT", "nogelu")),
    (5, ("D3DP_MLP_VARIANT", "nogelu")), (4, ("D3DP_SPATIAL_GROUP", "3"))])
def test_model_refuses_unported_switches(env, rng, level, setting):
    """MixSTE2 fp32 at a fuse level whose kernels read the switch, against
    the JAX model at that level under the same switch (1e-4); level 0 (the
    composed path, whose JAX counterpart reads no switch) is unchanged by
    it."""
    jcfg = JMixSTEConfig(**SMALL, attention_impl="pallas", fuse_level=level)
    params = random_params(jcfg, seed=1)
    x2d = rng.randn(3, 9, 17, 2).astype(np.float32)
    x3d = rng.randn(3, 9, 17, 3).astype(np.float32)
    t = np.array([1, 50, 999], np.int32)
    model = port_model(params, **SMALL, fuse_level=0)
    composed = model(*_t([x2d, x3d, t]))
    env.setenv(*setting)
    want = JMixSTE2(jcfg).apply({"params": params}, x2d, x3d, t)
    assert torch.equal(model(*_t([x2d, x3d, t])), composed)
    model.cfg = dataclasses.replace(model.cfg, fuse_level=level)
    np.testing.assert_allclose(model(*_t([x2d, x3d, t])).numpy(), np.asarray(want), atol=1e-4)


def _cfg():
    from d3dp_tpu_torch.models import MixSTEConfig
    return MixSTEConfig(**SMALL)


def test_resident_refuses_bf16exp(env, rng):
    """Under the global D3DP_ATTN_VARIANT=bf16exp the trunk (level 5, bf16)
    computes what the level-4 ops compute under it, bit for bit, and not
    what they compute without it."""
    model = MixSTE2(dataclasses.replace(_cfg(), fuse_level=5, dtype=torch.bfloat16),
                    device="cpu", seed=2)
    W = model._weights()
    x = torch.from_numpy(rng.randn(2, 9, 17, 64).astype(np.float32)).to(torch.bfloat16)
    args = (x, W["temporal_pos"][0], *W["resident"], 8, 0.35, 1e-6)
    base = tres.resident_block_stack(*args)
    env.setenv("D3DP_ATTN_VARIANT", "bf16exp")
    got = tres.resident_block_stack(*args)
    assert torch.equal(got, tres.resident_block_stack_plain(*args, opts=tattn.OPT_BF16_EXP))
    assert not torch.equal(got, base)
    x3d = torch.from_numpy(rng.randn(2, 9, 17, 3).astype(np.float32))
    x2d = torch.from_numpy(rng.randn(2, 9, 17, 2).astype(np.float32))
    t = torch.tensor([5, 600])
    level5 = model(x2d, x3d, t)
    model.cfg = dataclasses.replace(model.cfg, fuse_level=4)
    assert torch.equal(model(x2d, x3d, t), level5)


# ------------------------------------------------------------------- K8
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [17, 27, 130])
def test_attention_stage_hm_plain_matches_jax(env, rng, N, dtype):
    """K8's plain version against `_attention_stage_fwd` under hmqkv (the
    head-major Pallas kernel, weights stacked inside the JAX launcher)."""
    env.setenv("D3DP_ATTN_VARIANT", "hmqkv")
    R, C, h = 3, 128, 2
    arrs = _stage_inputs(rng, R, N, C)
    want = _attention_stage_fwd(*_jax_args(arrs, DTYPES[dtype]), h, (C // h) ** -0.5, 1e-6,
                                interpret=True)
    args = _t(arrs, dtype=dtype)
    whm, bhm = tattn.stack_head_major(args[1], args[2], h)
    got = tattn.attention_stage_hm_plain(args[0], whm, bhm, *args[3:], h, (C // h) ** -0.5,
                                         1e-6)
    for g, w in zip(got, want):
        _assert_close(g, w, dtype)
    # the public op under hmqkv is the head-major stage, bit for bit
    for a, b in zip(tattn.attention_stage(*args, h, (C // h) ** -0.5, 1e-6), got):
        assert torch.equal(a, b)


def test_stack_head_major_layout(rng):
    """Head i's block is [q_i | k_i | v_i], each d columns of wqkv and d
    entries of bqkv; the stacking is differentiable."""
    C, h = 128, 2
    d = C // h
    w = torch.from_numpy(rng.randn(C, 3 * C).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(rng.randn(3 * C).astype(np.float32))
    whm, bhm = tattn.stack_head_major(w, b, h)
    assert whm.shape == (h, C, 3 * d) and bhm.shape == (h, 1, 3 * d)
    for i in range(h):
        for part in range(3):
            cols = slice(part * C + i * d, part * C + (i + 1) * d)
            assert torch.equal(whm[i, :, part * d:(part + 1) * d], w[:, cols])
            assert torch.equal(bhm[i, 0, part * d:(part + 1) * d], b[cols])
    (g,) = torch.autograd.grad(whm.sum() * 2, w)
    assert torch.equal(g, torch.full_like(w, 2.0))


def test_hm_and_packed_stage_agree(rng):
    """K8 and K1 compute one function (fp32, summation order only)."""
    _, args = _stage_args(rng, R=3, N=20)
    whm, bhm = tattn.stack_head_major(args[1], args[2], 2)
    for a, b in zip(tattn.attention_stage_hm_plain(args[0], whm, bhm, *args[3:], 2, 0.125, 1e-6),
                    tattn.attention_stage_plain(*args, 2, 0.125, 1e-6)):
        torch.testing.assert_close(a, b, atol=2e-6, rtol=0)


@pytest.mark.parametrize("reuse", [False, True])
def test_mixste_level_4_hmqkv_matches_jax(env, rng, reuse):
    """MixSTE2 at fuse level 4 with D3DP_ATTN_VARIANT=hmqkv against JAX at
    level 4 with hmqkv (1e-4); the port takes the head-major op on every
    stage, with the weights stacked once in the weight cache. reuse: level
    5's reuse flow (a full call with a tap), which is level 4's."""
    env.setenv("D3DP_ATTN_VARIANT", "hmqkv")
    level = 5 if reuse else 4
    jcfg = JMixSTEConfig(**SMALL, attention_impl="pallas", fuse_level=level)
    params = random_params(jcfg, seed=1)
    B, F, J = 3, 9, 17
    x2d = rng.randn(B, F, J, 2).astype(np.float32)
    x3d = rng.randn(B, F, J, 3).astype(np.float32)
    t = rng.randint(0, 1000, (B,)).astype(np.int32)
    kw = dict(reuse_tap=1) if reuse else {}
    want = JMixSTE2(jcfg).apply({"params": params}, x2d, x3d, t, **kw)
    model = port_model(params, **SMALL, fuse_level=level)
    calls = []
    env.setattr(tattn, "attention_stage_hm",
                lambda *a, _f=tattn.attention_stage_hm, **k: calls.append(1) or _f(*a, **k))
    env.setattr(tattn, "attention_stage",
                lambda *a, **k: pytest.fail("the packed stage ran under hmqkv"))
    got = model(*_t([x2d, x3d, t]), **kw)
    assert len(calls) == 2 * SMALL["depth"]
    if reuse:
        (want, want_d), (got, got_d) = want, got
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    W = model._weights()
    assert torch.equal(W["ste"][0]["hm"][0],
                       tattn.stack_head_major(W["ste"][0]["wqkv"], W["ste"][0]["bqkv"], 8)[0])


def test_train_fused_hmqkv_matches_jax(env):
    """With D3DP_TRAIN_FUSED=1 at level 4 and hmqkv, the rate-0 blocks run
    the head-major stage (weights stacked inside the autograd forward) and
    the DropPath blocks the packed one, as in JAX; loss and gradients
    against JAX (2e-4)."""
    env.setenv("D3DP_TRAIN_FUSED", "1")
    env.setenv("D3DP_ATTN_VARIANT", "hmqkv")
    cfg = dict(SMALL, drop_path_rate=0.1, fuse_level=4)
    params = random_params(JMixSTEConfig(**SMALL), seed=3)
    batch = _batch(4)
    masks = _droppath_masks(cfg, 5)
    jloss, jgrads = _jax_loss_and_grads(params, cfg, "pallas", batch, masks, env)
    calls = []
    env.setattr(tattn, "attention_stage_hm",
                lambda *a, _f=tattn.attention_stage_hm, **k: calls.append(1) or _f(*a, **k))
    tloss, tgrads = _port_loss_and_grads(params, cfg, batch, masks)
    assert len(calls) == 2
    want = state_dict_from_flax(jgrads, cfg["depth"])
    assert abs(tloss - jloss) <= 2e-4 * abs(jloss)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g, want[name].numpy(), atol=2e-4, rtol=0, err_msg=name)

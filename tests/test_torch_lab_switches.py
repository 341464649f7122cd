"""The lab switches inside the stage, MLP and trunk kernels against the JAX
package, on the CPU.

The JAX package reads `D3DP_ATTN_VARIANT[_T|_S]`, `D3DP_SPATIAL_GROUP`,
`D3DP_SOFTMAX_FOLD` and `D3DP_MLP_VARIANT` when it traces a kernel; the port
reads them when an op is called and passes them to its kernels (on the CPU,
to their plain versions) as options. Each setting is held against the JAX
op or model under the same setting, run in interpret mode with JAX's
caches dropped around it (the `env` fixture).

Tolerances: fp32 2e-5 at op level (summation order only), 1e-4 for MixSTE2
and 2e-4 for the training loss and gradients (tests/test_torch_hmqkv.py);
bf16 switches that keep the production roundings at K1's band, 3e-2 plus
one bf16 ulp of the value; the grouped stage and bf16gelu at the JAX
suite's own 5e-2 (tests/test_pallas_ops.py:307, :366), since XLA on the
CPU keeps some bf16 intermediates of the polynomial in fp32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3dp_tpu.models import MixSTE2 as JMixSTE2, MixSTEConfig as JMixSTEConfig
from d3dp_tpu.ops.attention import _attention_stage_fwd
from d3dp_tpu.ops.mlp import _gelu_inkernel, _mlp_block_fwd, _mlp_block_t_fwd
from d3dp_tpu_torch.models import MixSTE2
from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.ops import mlp as tmlp
from d3dp_tpu_torch.ops import resident as tres
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from tests.test_torch_hmqkv import _cfg, _stage_args, env  # noqa: F401 (fixture)
from tests.test_torch_kernels import _excess, _mlp_inputs, _t
from tests.test_torch_model import SMALL, port_model, random_params
from tests.test_torch_ops import DTYPES, _assert_close, _jax_args
from tests.test_torch_train import (_batch, _droppath_masks, _jax_loss_and_grads,
                                    _port_loss_and_grads)

torch.set_num_threads(1)

C, HEADS = 128, 2
SCALE = (C // HEADS) ** -0.5
BAND_5E2 = {torch.float32: (2e-5, 0.0), torch.bfloat16: (5e-2, 0.0)}


def _np32(a):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32)))


def _jax_stage(arrs, dtype, dp=None):
    return _attention_stage_fwd(*_jax_args(arrs, DTYPES[dtype]), HEADS, SCALE, 1e-6,
                                interpret=True,
                                dp_row=None if dp is None else jnp.asarray(dp.numpy()))


# --------------------------------------------------------------- resolution
@pytest.mark.parametrize("setting,dp,want", [
    ({}, False, ("packed", 0, 1)),
    ({"D3DP_ATTN_VARIANT": "pipelined"}, False, ("packed", 0, 1)),
    ({"D3DP_ATTN_VARIANT": "bf16exp"}, False, ("packed", tattn.OPT_BF16_EXP, 1)),
    ({"D3DP_ATTN_VARIANT": "noy2"}, True, ("packed", 0, 1)),
    ({"D3DP_ATTN_VARIANT": "hmqkv"}, True, ("packed", 0, 1)),
    ({"D3DP_ATTN_VARIANT": "hmqkv", "D3DP_SPATIAL_GROUP": "2"}, False, ("packed", 0, 2)),
    ({"D3DP_SPATIAL_GROUP": "2"}, True, ("packed", 0, 1)),
    ({"D3DP_SPATIAL_GROUP": "3"}, False, ("packed", 0, 1)),
    ({"D3DP_SOFTMAX_FOLD": "0", "D3DP_ATTN_VARIANT": "hmqkv"}, False,
     ("head_major", tattn.OPT_NORM_FIRST, 1))])
def test_stage_config_resolves_as_jax(env, setting, dp, want):
    """`_attention_stage_fwd`'s resolution on a bf16 spatial stage of 4
    rows: the DropPath form never groups and runs the lab-only variants as
    production; hmqkv under grouping runs the masked K1; 3 does not divide
    4 rows."""
    for k, v in setting.items():
        env.setenv(k, v)
    x = torch.zeros(4, 17, C, dtype=torch.bfloat16)
    assert tattn.stage_config(x, dp=dp) == want


def test_batched_with_grouping_raises_in_both_packages(env, rng):
    """The JAX stage kernel asserts that grouping and `batched` do not
    compose; the port raises too, and never silently computes either."""
    env.setenv("D3DP_ATTN_VARIANT", "batched")
    env.setenv("D3DP_SPATIAL_GROUP", "2")
    arrs, args = _stage_args(rng, R=4, N=17, C=C)
    with pytest.raises(AssertionError):
        _jax_stage(arrs, torch.float32)
    with pytest.raises(ValueError, match="do not compose"):
        tattn.attention_stage(*args, HEADS, SCALE, 1e-6)
    # the DropPath form never groups, as in JAX
    dp = torch.ones(4)
    for g, w in zip(tattn.attention_stage_dp(*args, dp, HEADS, SCALE, 1e-6),
                    _jax_stage(arrs, torch.float32, dp)):
        _assert_close(g, w, torch.float32)


# ---------------------------------------------------------- softmax fold
@pytest.mark.parametrize("N", [17, 130])
@pytest.mark.parametrize("form", ["stage", "stage_dp", "stage_hm"])
def test_softmax_fold_0_bf16_matches_jax(env, rng, form, N):
    """D3DP_SOFTMAX_FOLD=0 in bf16 rounds p / l before P.V in K1, K1-dp and
    K8: each against the JAX kernel under the same setting at K1's band,
    and not equal to the folded order."""
    env.setenv("D3DP_SOFTMAX_FOLD", "0")
    if form == "stage_hm":
        env.setenv("D3DP_ATTN_VARIANT", "hmqkv")
    arrs, args = _stage_args(rng, R=3, N=N, C=C, dtype=torch.bfloat16)
    dp = torch.tensor([0.0, 1.0 / 0.9, 1.0 / 0.9]) if form == "stage_dp" else None
    want = _jax_stage(arrs, torch.bfloat16, dp)
    if form == "stage_dp":
        got = tattn.attention_stage_dp(*args, dp, HEADS, SCALE, 1e-6)
    else:
        got = tattn.attention_stage(*args, HEADS, SCALE, 1e-6)
    for g, w in zip(got, want):
        _assert_close(g, w, torch.bfloat16)
    folded = tattn.attention_stage_plain(*args, HEADS, SCALE, 1e-6,
                                         dp_row=None if dp is None else dp)
    assert not torch.equal(got[0], folded[0])


# ---------------------------------------------------------- grouped stage
GROUPS = [(3, 6), (16, 16)]  # (g, R) at N0 = 17: 51 and 272 tokens a fold


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,R", GROUPS)
@pytest.mark.parametrize("variant", ["", "pipelined", "phasesplit", "bf16exp", "hmqkv"])
def test_grouped_stage_matches_jax(env, rng, variant, g, R, dtype):
    """D3DP_SPATIAL_GROUP=g folds g 17-token sequences into one masked
    attention (g * 17 may exceed 256): against JAX grouped under the same
    variant (fp32 2e-5, bf16 5e-2) and, in fp32, against the port's
    ungrouped result (1e-5: the mask leaves each query its own keys)."""
    if variant:
        env.setenv("D3DP_ATTN_VARIANT", variant)
    arrs, args = _stage_args(rng, R=R, N=17, C=C, dtype=dtype)
    ungrouped = tattn.attention_stage(*args, HEADS, SCALE, 1e-6)
    env.setenv("D3DP_SPATIAL_GROUP", str(g))
    jax.clear_caches()
    want = _jax_stage(arrs, dtype)
    got = tattn.attention_stage(*args, HEADS, SCALE, 1e-6)
    for gv, w, u in zip(got, want, ungrouped):
        assert gv.shape == (R, 17, C)
        assert _excess(gv, _np32(w), dtype, BAND_5E2) <= 0
        if dtype == torch.float32:
            torch.testing.assert_close(gv, u, atol=1e-5, rtol=0)


# ------------------------------------------------------------------ MLP
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["nogelu", "bf16gelu", "other"])
@pytest.mark.parametrize("form", ["rows", "rows_dp", "t", "t_dp"])
def test_mlp_variants_match_jax(env, rng, form, variant, dtype):
    """D3DP_MLP_VARIANT in K5, K5-dp, K2 and K2-dp against the JAX kernels
    under the same setting: nogelu the identity in both dtypes, bf16gelu the
    bf16 polynomial in bf16 (5e-2, the JAX suite's band) and the exact GELU
    in fp32, any other value the exact GELU (fp32 2e-5, bf16 K2's band)."""
    env.setenv("D3DP_MLP_VARIANT", variant)
    Cm, H, D1, D2 = 64, 128, 6, 5
    arrs = _mlp_inputs(rng, 2, D1, D2, Cm, H)
    if form.startswith("rows"):
        arrs[:2] = [a.reshape(2 * D1 * D2, Cm) for a in arrs[:2]]
    dp = (rng.rand(*arrs[0].shape[:(1 if form == "rows_dp" else 2)]) < 0.8) / 0.8
    dp = dp.astype(np.float32)
    jargs = _jax_args(arrs, DTYPES[dtype])
    args = _t(arrs, dtype=dtype)
    jdp = jnp.asarray(dp) if form.endswith("dp") else None
    tdp = torch.from_numpy(dp)
    if form.startswith("rows"):
        want = _mlp_block_fwd(*jargs, 1e-6, interpret=True, dp=jdp)
        got = (tmlp.mlp_block_dp(*args, tdp, 1e-6) if jdp is not None
               else tmlp.mlp_block(*args, 1e-6))
    else:
        want = _mlp_block_t_fwd(*jargs, 1e-6, interpret=True, dp=jdp)
        got = (tmlp.mlp_block_t_dp(*args, tdp, 1e-6) if jdp is not None
               else tmlp.mlp_block_t(*args, 1e-6))
    if variant == "bf16gelu" and dtype == torch.bfloat16:
        assert _excess(got, _np32(want), dtype, BAND_5E2) <= 0
    else:
        _assert_close(got, want, dtype)


def test_gelu_bf16_is_the_jax_polynomial_to_a_bf16_ulp(env, rng):
    """`gelu_bf16` against the JAX kernel's bf16gelu activation on 1e5
    values of |h| up to about 12: within one bf16 ulp of the value (the
    JAX side keeps some of its bf16 steps in fp32 on the CPU), and within
    the polynomial's bf16 error of the exact GELU."""
    env.setenv("D3DP_MLP_VARIANT", "bf16gelu")
    h = (rng.randn(100000) * 3).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: _gelu_inkernel(v, False))(jnp.asarray(h)))
    got = tmlp.gelu_bf16(torch.from_numpy(h)).numpy()
    assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(h)).numpy()
    assert np.all(np.abs(got - exact) <= 2.0 ** -6 * np.abs(exact) + 2e-2)


# ------------------------------------------------------------ MixSTE2
def _model_vs_jax(rng, level):
    jcfg = JMixSTEConfig(**SMALL, attention_impl="pallas", fuse_level=level)
    params = random_params(jcfg, seed=1)
    B, F, J = 4, 9, 17
    x2d = rng.randn(B, F, J, 2).astype(np.float32)
    x3d = rng.randn(B, F, J, 3).astype(np.float32)
    t = rng.randint(0, 1000, (B,)).astype(np.int32)
    want = JMixSTE2(jcfg).apply({"params": params}, x2d, x3d, t)
    got = port_model(params, **SMALL, fuse_level=level)(*_t([x2d, x3d, t]))
    return got, want


@pytest.mark.parametrize("setting", [("D3DP_ATTN_VARIANT", "other"),
                                     ("D3DP_ATTN_VARIANT", "bf16exp"),
                                     ("D3DP_MLP_VARIANT", "nogelu")])
def test_mixste_level_4_under_switch_matches_jax(env, rng, setting):
    """MixSTE2 fp32 at fuse level 4 under the switch against the JAX model
    under it (1e-4): production math for the unknown variant and bf16exp
    in fp32, the identity activation under nogelu."""
    env.setenv(*setting)
    got, want = _model_vs_jax(rng, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("setting", [("D3DP_ATTN_VARIANT", "bf16exp"),
                                     ("D3DP_SOFTMAX_FOLD", "0"),
                                     ("D3DP_MLP_VARIANT", "bf16gelu"),
                                     ("D3DP_MLP_VARIANT", "nogelu")])
def test_level_5_equals_level_4_in_bf16_under_switch(env, rng, setting):
    """Under the global switches the trunk (level 5) computes what the
    level-4 ops compute, bit for bit in bf16; and the switch changes the
    result."""
    model = _bf16_model(rng)
    x2d, x3d = _t([rng.randn(2, 9, 17, 2).astype(np.float32),
                   rng.randn(2, 9, 17, 3).astype(np.float32)])
    t = torch.tensor([3, 700])
    base = model(x2d, x3d, t)
    env.setenv(*setting)
    out = {}
    for level in (4, 5):
        model.cfg = dataclasses.replace(model.cfg, fuse_level=level)
        out[level] = model(x2d, x3d, t)
    assert torch.equal(out[4], out[5])
    assert not torch.equal(out[5], base)


def _bf16_model(rng):
    from d3dp_tpu_torch.models import MixSTE2
    model = MixSTE2(dataclasses.replace(_cfg(), fuse_level=5, dtype=torch.bfloat16),
                    device="cpu", seed=4)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) * 0.05)
    return model


def test_per_stage_bf16exp_does_not_reach_the_trunk(env, rng):
    """As in JAX, the trunk kernel reads the global D3DP_ATTN_VARIANT only:
    D3DP_ATTN_VARIANT_S=bf16exp changes level 4's spatial stages, not level
    5."""
    model = _bf16_model(rng)
    x2d, x3d = _t([rng.randn(2, 9, 17, 2).astype(np.float32),
                   rng.randn(2, 9, 17, 3).astype(np.float32)])
    t = torch.tensor([3, 700])
    base = model(x2d, x3d, t)
    env.setenv("D3DP_ATTN_VARIANT_S", "bf16exp")
    assert tres.resident_options(torch.bfloat16) == (0, tmlp.GELU_ERF)
    assert torch.equal(model(x2d, x3d, t), base)
    model.cfg = dataclasses.replace(model.cfg, fuse_level=4)
    assert not torch.equal(model(x2d, x3d, t), base)


# ------------------------------------------------------------ training
def test_train_fused_nogelu_matches_jax(env):
    """D3DP_TRAIN_FUSED=1 at level 4, fp32, depth 2, DropPath 0.1, under
    nogelu: the forward drops the activation while both backwards
    differentiate the exact GELU (JAX `_mlp_bwd_impl`); loss and every
    gradient against JAX at 2e-4, and the loss differs from the GELU one."""
    env.setenv("D3DP_TRAIN_FUSED", "1")
    cfg = dict(SMALL, drop_path_rate=0.1, fuse_level=4)
    params = random_params(JMixSTEConfig(**SMALL), seed=3)
    batch = _batch(4)
    masks = _droppath_masks(cfg, 5)
    gelu_loss, _ = _port_loss_and_grads(params, cfg, batch, masks)
    env.setenv("D3DP_MLP_VARIANT", "nogelu")
    jloss, jgrads = _jax_loss_and_grads(params, cfg, "pallas", batch, masks, env)
    tloss, tgrads = _port_loss_and_grads(params, cfg, batch, masks)
    want = state_dict_from_flax(jgrads, cfg["depth"])
    assert abs(tloss - jloss) <= 2e-4 * abs(jloss)
    assert abs(tloss - gelu_loss) > 1e-4
    for name, g in tgrads.items():
        np.testing.assert_allclose(g, want[name].numpy(), atol=2e-4, rtol=0, err_msg=name)


def test_train_fused_under_grouping_raises_in_both_packages(env):
    """Grouping is eval-only: the stage backward refuses it in both
    packages (the rate-0 blocks of the fused flow group their forward)."""
    env.setenv("D3DP_TRAIN_FUSED", "1")
    env.setenv("D3DP_SPATIAL_GROUP", "3")
    cfg = dict(SMALL, drop_path_rate=0.1, fuse_level=4)
    params = random_params(JMixSTEConfig(**SMALL), seed=3)
    batch = _batch(4)
    masks = _droppath_masks(cfg, 5)
    with pytest.raises(NotImplementedError, match="D3DP_SPATIAL_GROUP"):
        _jax_loss_and_grads(params, cfg, "pallas", batch, masks, env)
    with pytest.raises(NotImplementedError, match="D3DP_SPATIAL_GROUP"):
        _port_loss_and_grads(params, cfg, batch, masks)

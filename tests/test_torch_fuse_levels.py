"""The port's fuse-level ladder against the JAX package's, fp32 on the CPU:
the MLP-block (K5), attention-block (K6) and packed-attention (K7) ops'
plain versions against the Pallas kernels in interpret mode (atol 2e-5, the
ops tolerance of tests/test_torch_ops.py), the port's MixSTE2 at fuse
levels 0-5 against JAX's `MixSTE2(attention_impl="pallas", fuse_level=L)`
with the same weights, on three windows and on one (atol 1e-4,
tests/test_mixste.py), and the level-2 sampler and the one-window sampler at
levels 1-2 with injected noise (atol 5e-4, the DDIM replay tolerance)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.models import MixSTE2 as JMixSTE2, MixSTEConfig as JMixSTEConfig
from d3dp_tpu.ops.attention import _attention_block_fwd, fused_attention_packed as j_packed
from d3dp_tpu.ops.mlp import _mlp_block_fwd
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig
from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.ops import mlp as tmlp
from tests.test_torch_model import SMALL, port_model, random_params

torch.set_num_threads(1)


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def test_mlp_block_plain_matches_pallas(rng):
    """37 rows in tiles of 16: the last tile is partial."""
    R, C, H = 37, 64, 128
    x, res = rng.randn(R, C).astype(np.float32), rng.randn(R, C).astype(np.float32)
    w1 = (rng.randn(C, H) * 0.1).astype(np.float32)
    b1 = (rng.randn(H) * 0.1).astype(np.float32)
    w2 = (rng.randn(H, C) * 0.1).astype(np.float32)
    b2 = (rng.randn(C) * 0.1).astype(np.float32)
    s = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    b = (0.1 * rng.randn(C)).astype(np.float32)
    want = np.asarray(_mlp_block_fwd(x, res, w1, b1, w2, b2, s, b, 1e-6, interpret=True, tr=16))
    got = tmlp.mlp_block(*_t(x, res, w1, b1, w2, b2, s, b), 1e-6)
    assert got.shape == (R, C) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # the transposing form is the same rows, relayouted
    got_t = tmlp.mlp_block_t(*_t(x.reshape(1, R, 1, C), res.reshape(1, R, 1, C), w1, b1, w2,
                                 b2, s, b), 1e-6)
    np.testing.assert_array_equal(got_t.reshape(R, C).numpy(), got.numpy())


@pytest.mark.parametrize("N", [17, 129])
def test_attention_block_plain_matches_pallas(rng, N):
    R, C, heads = 3, 64, 4
    qkv = rng.randn(R, N, 3 * C).astype(np.float32)
    res = rng.randn(R, N, C).astype(np.float32)
    w = (rng.randn(C, C) * 0.1).astype(np.float32)
    b = (rng.randn(C) * 0.1).astype(np.float32)
    s = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    lb = (0.1 * rng.randn(C)).astype(np.float32)
    scale = (C // heads) ** -0.5
    want = _attention_block_fwd(qkv, res, w, b, s, lb, heads, scale, 1e-6, interpret=True)
    got = tattn.attention_block(*_t(qkv, res, w, b, s, lb), heads, scale, 1e-6)
    for g, wnt in zip(got, want):
        assert g.shape == (R, N, C)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=2e-5)


@pytest.mark.parametrize("N", [17, 243])
def test_fused_attention_plain_matches_pallas(rng, N):
    B, heads, d = 4, 4, 16
    q, k, v = (rng.randn(B, N, heads * d).astype(np.float32) for _ in range(3))
    want = np.asarray(j_packed(q, k, v, heads, d ** -0.5, interpret=True))
    got = tattn.fused_attention_packed(*_t(q, k, v), heads, d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # the (B, N, h, d) wrapper is the same op
    shaped = tattn.fused_attention(*(t.view(B, N, heads, d) for t in _t(q, k, v)), d ** -0.5)
    np.testing.assert_array_equal(shaped.reshape(B, N, heads * d).numpy(), got.numpy())


@pytest.mark.parametrize("level, B", [pytest.param(level, 3, id=str(level)) for level in range(6)]
                         + [pytest.param(level, 1, id=f"{level}-B1") for level in range(6)])
def test_mixste_fuse_level_matches_jax(rng, level, B):
    """Port vs JAX MixSTE2 at one fuse level, same weights, atol 1e-4, on
    three windows and on one (at B = 1 the stage relayouts are views)."""
    jcfg = JMixSTEConfig(**SMALL, attention_impl="pallas", fuse_level=level)
    params = random_params(jcfg, seed=1)
    F, J = 9, 17
    x2d = rng.randn(B, F, J, 2).astype(np.float32)
    x3d = rng.randn(B, F, J, 3).astype(np.float32)
    t = rng.randint(0, 1000, (B,)).astype(np.int32)
    want = np.asarray(JMixSTE2(jcfg).apply({"params": params}, x2d, x3d, t))
    model = port_model(params, **SMALL, fuse_level=level)
    counts = {f: f.launches for f in _kernel_ops()}
    got = model(*_t(x2d, x3d, t)).numpy()
    assert got.shape == (B, F, J, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)
    # on the CPU every op runs its plain version: no kernel launches
    assert counts == {f: f.launches for f in _kernel_ops()}


def _kernel_ops():
    return (tattn.attention_stage, tattn.attention_block, tattn.fused_attention_qkv,
            tattn.fused_attention_packed, tmlp.mlp_block_t, tmlp.mlp_block)


def test_fuse_levels_agree_and_level_5_is_not_ported(rng):
    """Every level 0-5 computes the same function (fp32 summation order
    only), the eval path builds no autograd graph at any level, and level
    6 does not exist. (Level 5, the depth-resident trunk, is ported: the
    name is kept from the ladder's earlier state.)"""
    model = MixSTE2(MixSTEConfig(**SMALL), device="cpu", seed=3)
    x2d, x3d = _t(rng.randn(2, 9, 17, 2).astype(np.float32),
                  rng.randn(2, 9, 17, 3).astype(np.float32))
    t = torch.tensor([5, 900])
    outs = []
    for level in range(6):
        model.cfg = dataclasses.replace(model.cfg, fuse_level=level)
        out = model(x2d, x3d, t)
        assert not out.requires_grad
        outs.append(out)
    for out in outs:
        torch.testing.assert_close(out, outs[4], atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="0..5"):
        MixSTEConfig(fuse_level=6)


def test_sample_level_2_matches_jax(rng):
    B, H, K, F, J = 2, 2, 3, 9, 17
    jcfg = JMixSTEConfig(**SMALL, attention_impl="pallas", fuse_level=2)
    params = random_params(jcfg, seed=2)
    kw = dict(num_proposals=H, sampling_timesteps=K)
    jd = JD3DP(JD3DPConfig(model=jcfg, **kw))
    td = D3DP(D3DPConfig(model=MixSTEConfig(**SMALL, fuse_level=2), **kw),
              model=port_model(params, **SMALL, fuse_level=2))
    x2d = (rng.randn(B, F, J, 2) * 0.3).astype(np.float32)
    x2d_f = (rng.randn(B, F, J, 2) * 0.3).astype(np.float32)
    img0 = rng.randn(B, H, F, J, 3).astype(np.float32)
    steps = rng.randn(K, B, H, F, J, 3).astype(np.float32)
    want = np.asarray(jd.sample({"params": params}, jax.random.PRNGKey(0), x2d, x2d_f,
                                noise_override=(img0, steps)))
    got = td.sample(*_t(x2d, x2d_f), noise_override=(img0, steps)).numpy()
    assert got.shape == (B, K, H, F, J, 3)
    np.testing.assert_allclose(got, want, atol=5e-4)


@pytest.mark.parametrize("level", [1, 2])
def test_sample_one_window_matches_jax(rng, level):
    """One window, one hypothesis, no flip-TTA: the model sees B = 1, where
    the relayouts between the stages are views of the stream."""
    B, H, K, F, J = 1, 1, 3, 9, 17
    jcfg = JMixSTEConfig(**SMALL, attention_impl="pallas", fuse_level=level)
    params = random_params(jcfg, seed=2)
    kw = dict(num_proposals=H, sampling_timesteps=K, flip_tta=False)
    jd = JD3DP(JD3DPConfig(model=jcfg, **kw))
    td = D3DP(D3DPConfig(model=MixSTEConfig(**SMALL, fuse_level=level), **kw),
              model=port_model(params, **SMALL, fuse_level=level))
    x2d = (rng.randn(B, F, J, 2) * 0.3).astype(np.float32)
    img0 = rng.randn(B, H, F, J, 3).astype(np.float32)
    steps = rng.randn(K, B, H, F, J, 3).astype(np.float32)
    want = np.asarray(jd.sample({"params": params}, jax.random.PRNGKey(0), x2d,
                                noise_override=(img0, steps)))
    got = td.sample(torch.from_numpy(x2d), noise_override=(img0, steps)).numpy()
    assert got.shape == (B, K, H, F, J, 3)
    np.testing.assert_allclose(got, want, atol=5e-4)

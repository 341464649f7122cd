"""d3dp_tpu_torch schedule, weight bridge, MixSTE2 and DDIM sampler against
the JAX package, fp32 on the CPU, same weights and same injected noise.

Tolerances are the JAX suite's against the original PyTorch code: model
1e-4 (tests/test_mixste.py), DDIM replay 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.diffusion import schedule as jsched
from d3dp_tpu.models import MixSTE2 as JMixSTE2, MixSTEConfig as JMixSTEConfig
from d3dp_tpu.train.convert_torch import torch_mixste_to_flax
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.diffusion import schedule as tsched
from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig
from d3dp_tpu_torch.train.convert import state_dict_from_flax, strip_prefixes

torch.set_num_threads(1)

SMALL = dict(num_frames=9, num_joints=17, embed_dim=64, depth=2, num_heads=8)


def random_params(jcfg, seed=0, scale=0.05):
    """JAX MixSTE2 'params' tree with random leaves (numpy fp32): LayerNorm
    scales 1 + scale*N(0,1), every other leaf (kernels, biases, position
    embeddings) scale*N(0,1)."""
    B, F, J = 1, jcfg.num_frames, jcfg.num_joints
    params = JMixSTE2(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((B, F, J, jcfg.in_chans)),
        jnp.zeros((B, F, J, 3)), jnp.zeros((B,), jnp.int32))["params"]
    rng = np.random.RandomState(seed)

    def leaf(path, p):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + scale * rng.randn(*np.shape(p))).astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, params)


def port_model(params_np, **cfg):
    model = MixSTE2(MixSTEConfig(**cfg), device="cpu")
    model.load_state_dict(state_dict_from_flax(params_np, cfg["depth"]))
    return model


def test_schedule_tables_equal_jax():
    for a, b in ((tsched.cosine_beta_schedule(1000), jsched.cosine_beta_schedule(1000)),):
        assert a.dtype == np.float64 and np.array_equal(a, b)
    for K in (1, 2, 5, 10, 20):
        assert tsched.ddim_time_pairs(1000, K) == jsched.ddim_time_pairs(1000, K)
    ts, js = tsched.CosineSchedule(1000), jsched.CosineSchedule(1000)
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
                 "sqrt_one_minus_alphas_cumprod", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_variance"):
        assert np.array_equal(getattr(ts, name), getattr(js, name)), name
    for K in (2, 5, 10):
        tc, jc = ts.ddim_step_constants(K, 1.0), js.ddim_step_constants(K, 1.0)
        assert tc.keys() == jc.keys()
        for k in tc:
            assert tc[k].dtype == jc[k].dtype and np.array_equal(tc[k], jc[k]), k


def test_state_dict_round_trips_bit_exact():
    jcfg = JMixSTEConfig(**SMALL)
    params = random_params(jcfg)
    sd = state_dict_from_flax(params, depth=2)
    back = torch_mixste_to_flax(sd, depth=2)
    flat_a = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        assert np.array_equal(np.asarray(leaf), np.asarray(flat_b[path])), path
    # the original key names are exactly the port's module names
    model = MixSTE2(MixSTEConfig(**SMALL), device="cpu")
    assert set(model.state_dict()) == set(sd)
    model.load_state_dict(strip_prefixes({f"module.pose_estimator.{k}": v
                                          for k, v in sd.items()}))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mixste_matches_jax(rng, impl):
    """Port vs JAX MixSTE2: the composed XLA path and the Pallas level-4
    path (interpret mode), atol 1e-4."""
    jcfg = JMixSTEConfig(**SMALL, attention_impl=impl, fuse_level=4)
    params = random_params(jcfg, seed=1)
    B, F, J = 3, 9, 17
    x2d = rng.randn(B, F, J, 2).astype(np.float32)
    x3d = rng.randn(B, F, J, 3).astype(np.float32)
    t = rng.randint(0, 1000, (B,)).astype(np.int32)
    want = np.asarray(JMixSTE2(jcfg).apply({"params": params}, x2d, x3d, t))
    with torch.no_grad():
        got = port_model(params, **SMALL)(
            torch.from_numpy(x2d), torch.from_numpy(x3d), torch.from_numpy(t)).numpy()
    assert got.shape == (B, F, J, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_sample_noise_override_matches_jax(rng):
    B, H, K, F, J = 2, 2, 3, 9, 17
    jcfg = JMixSTEConfig(**SMALL)
    params = random_params(jcfg, seed=2)
    kw = dict(num_proposals=H, sampling_timesteps=K)
    jd = JD3DP(JD3DPConfig(model=jcfg, **kw))
    td = D3DP(D3DPConfig(model=MixSTEConfig(**SMALL), **kw),
              model=port_model(params, **SMALL))
    x2d = (rng.randn(B, F, J, 2) * 0.3).astype(np.float32)
    x2d_f = (rng.randn(B, F, J, 2) * 0.3).astype(np.float32)
    img0 = rng.randn(B, H, F, J, 3).astype(np.float32)
    steps = rng.randn(K, B, H, F, J, 3).astype(np.float32)
    want = np.asarray(jd.sample({"params": params}, jax.random.PRNGKey(0), x2d, x2d_f,
                                noise_override=(img0, steps)))
    got = td.sample(torch.from_numpy(x2d), torch.from_numpy(x2d_f),
                    noise_override=(img0, steps)).numpy()
    assert got.shape == (B, K, H, F, J, 3)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_sample_needs_explicit_randomness():
    td = D3DP(D3DPConfig(model=MixSTEConfig(**SMALL)), device="cpu")
    x = torch.zeros(1, 9, 17, 2)
    with pytest.raises(ValueError):
        td.sample(x, x)
    out = td.sample(x, x, generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, 5, 1, 9, 17, 3) and torch.isfinite(out).all()

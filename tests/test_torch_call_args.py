"""The last two argument surfaces of the JAX package that the port lacked,
against the JAX package on the CPU:

* `D3DP.sample(..., num_proposals=, sampling_timesteps=)`: H and K for one
  call, at fuse levels 4 and 5 (and level 5 with feature reuse), held
  against JAX's per-call arguments on injected noise at 5e-4 (the DDIM
  replay tolerance) and against a port sampler configured with that H and
  K bit for bit; the generator's draws take this call's shapes.
* `ChunkedGenerator(batch_size, cameras, poses_3d, poses_2d, chunk_length,
  pad, causal_shift, ...)` in the JAX package's positional order, its
  `batch_num()` and `augment_enabled()`, and the same batches as JAX's.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from d3dp_tpu.data import synthetic as jsyn
from d3dp_tpu.data.generators import ChunkedGenerator as JChunked
from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.models import MixSTEConfig as JMixSTEConfig
from d3dp_tpu_torch.data.generators import ChunkedGenerator
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.models import MixSTEConfig
from tests.test_torch_model import port_model, random_params

torch.set_num_threads(1)

SMALL = dict(num_frames=9, num_joints=17, embed_dim=64, depth=2, num_heads=8)
B, F, J = 2, 9, 17


def _samplers(level, H, K, **kw):
    """(JAX sampler, port sampler, port sampler with H and K configured),
    the two port ones on the same weights; the config's own H and K are
    1 and 5."""
    jcfg = JMixSTEConfig(**SMALL, attention_impl="pallas", fuse_level=level)
    params = random_params(jcfg, seed=2)
    jd = JD3DP(JD3DPConfig(model=jcfg, **kw))
    cfg = D3DPConfig(model=MixSTEConfig(**SMALL, fuse_level=level), **kw)
    model = port_model(params, **SMALL, fuse_level=level)
    td = D3DP(cfg, model=model)
    fixed = D3DP(dataclasses.replace(cfg, num_proposals=H, sampling_timesteps=K), model=model)
    return params, jd, td, fixed


@pytest.mark.parametrize("level,H,K,reuse", [(4, 3, 2, 1), (5, 3, 2, 1), (4, 2, 7, 1),
                                             (5, 2, 4, 2)])
def test_sample_per_call_h_and_k(rng, level, H, K, reuse):
    kw = dict(reuse_interval=reuse, reuse_tap=1) if reuse > 1 else {}
    params, jd, td, fixed = _samplers(level, H, K, **kw)
    assert (td.cfg.num_proposals, td.cfg.sampling_timesteps) == (1, 5)
    x2d, x2d_f = ((rng.randn(B, F, J, 2) * 0.3).astype(np.float32) for _ in range(2))
    img0 = rng.randn(B, H, F, J, 3).astype(np.float32)
    steps = rng.randn(K, B, H, F, J, 3).astype(np.float32)
    want = np.asarray(jd.sample({"params": params}, jax.random.PRNGKey(0), x2d, x2d_f,
                                num_proposals=H, sampling_timesteps=K,
                                noise_override=(img0, steps)))
    x = (torch.from_numpy(x2d), torch.from_numpy(x2d_f))
    got = td.sample(*x, noise_override=(img0, steps), num_proposals=H,
                    sampling_timesteps=K).numpy()
    assert got.shape == want.shape == (B, K, H, F, J, 3)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    np.testing.assert_array_equal(got, fixed.sample(*x, noise_override=(img0, steps)).numpy())


def test_sample_draws_per_call_shapes():
    """The generator's draws: this call's H and K, in sample_noise's order,
    so a per-call sample equals a configured sampler's on one seed."""
    _, _, td, fixed = _samplers(4, 3, 2)
    img0, steps = td.sample_noise(B, torch.Generator().manual_seed(5), 3, 2)
    assert img0.shape == (B, 3, F, J, 3) and steps.shape == (2, B, 3, F, J, 3)
    for a, b in zip((img0, steps), fixed.sample_noise(B, torch.Generator().manual_seed(5))):
        assert torch.equal(a, b)
    x = torch.zeros(B, F, J, 2)
    got = td.sample(x, x, generator=torch.Generator().manual_seed(7), num_proposals=3,
                    sampling_timesteps=2)
    assert torch.equal(got, fixed.sample(x, x, generator=torch.Generator().manual_seed(7)))
    assert td.sample(x, x, generator=torch.Generator()).shape == (B, 5, 1, F, J, 3)


@pytest.mark.parametrize("pad,causal_shift,augment", [(0, 0, False), (13, 0, True),
                                                      (4, 2, True)])
def test_chunked_generator_positional_arguments_match_jax(pad, causal_shift, augment):
    """JAX's positional order (pad and causal_shift after chunk_length),
    both stored and unused in the extraction, as JAX's; batch_num() and
    augment_enabled() as JAX's; the same batches."""
    data = jsyn.make_dataset(seed=2, lengths=(100, 80, 30))
    lr = dict(kps_left=list(jsyn.JOINTS_LEFT), kps_right=list(jsyn.JOINTS_RIGHT),
              joints_left=list(jsyn.JOINTS_LEFT), joints_right=list(jsyn.JOINTS_RIGHT))
    tg = ChunkedGenerator(4, *data, 27, pad, causal_shift, True, 1234, augment, **lr)
    jg = JChunked(4, *data, 27, pad, causal_shift, True, 1234, augment, **lr,
                  use_native=False)
    assert (tg.pad, tg.causal_shift) == (jg.pad, jg.causal_shift) == (pad, causal_shift)
    assert tg.batch_num() == jg.batch_num() == tg.num_batches
    assert tg.num_frames() == jg.num_frames() == tg.batch_num() * 4
    assert tg.augment_enabled() is jg.augment_enabled() is augment
    plain = ChunkedGenerator(4, *data, 27, shuffle=True, random_seed=1234, augment=augment,
                             **lr)
    got, want, base = (list(g.next_epoch()) for g in (tg, jg, plain))
    assert len(got) == len(want) == tg.batch_num()
    for a, b, c in zip(got, want, base):
        for x, y, z in zip(a, b, c):
            assert np.array_equal(x, y) and np.array_equal(x, z)

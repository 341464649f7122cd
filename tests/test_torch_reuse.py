"""DDIM feature reuse against the JAX package, on the CPU: the refresh
schedule (equal), the model's full/reuse contract at every fuse level
(tests/test_ddim_reuse.py:53-95's, atol 1e-6 in fp32), the model's
(output, delta) against JAX's (atol 1e-4, tests/test_mixste.py), the
sampler with fixed and adaptive reuse at fuse levels 0, 3, 4 and 5 with
injected noise (atol 5e-4, the DDIM replay tolerance), and the command
line's evaluation with `--ddim-reuse 2` (3.1e-4 mm)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.diffusion.d3dp import reuse_schedule as j_reuse_schedule
from d3dp_tpu.models import MixSTE2 as JMixSTE2, MixSTEConfig as JMixSTEConfig
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.diffusion.d3dp import reuse_schedule
from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig
from tests.test_torch_cli import run_evaluation_against_jax
from tests.test_torch_model import SMALL, port_model, random_params

torch.set_num_threads(1)

B, F, J = 2, 9, 17


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


@pytest.mark.parametrize("interval", [1, 2, 3, 4])
def test_reuse_schedule_matches_jax(interval):
    for k in range(1, 13):
        got = reuse_schedule(k, interval)
        assert got.dtype == np.bool_ and got[-1]
        np.testing.assert_array_equal(got, np.asarray(j_reuse_schedule(k, interval)))


@pytest.fixture(scope="module")
def model():
    m = MixSTE2(MixSTEConfig(**SMALL), device="cpu", seed=3)
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    return m


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4, 5])
def test_full_call_delta_resumes_to_the_full_output(model, level):
    """A full call returns the plain output and a delta; resumed at the
    same input with that delta, the reuse call reproduces the full output.
    tap == depth gives a zero delta."""
    model.cfg = dataclasses.replace(model.cfg, fuse_level=level)
    rng = np.random.RandomState(1)
    x2d, x3d = _t(rng.randn(B, F, J, 2).astype(np.float32),
                  rng.randn(B, F, J, 3).astype(np.float32))
    t = torch.tensor([3, 700])
    plain = model(x2d, x3d, t)
    for tap in range(1, SMALL["depth"] + 1):
        out, delta = model(x2d, x3d, t, reuse_tap=tap)
        torch.testing.assert_close(out, plain, atol=1e-6, rtol=0)
        assert delta.shape == (B, F, J, SMALL["embed_dim"]) and delta.dtype == torch.float32
        resumed = model(x2d, x3d, t, reuse_tap=tap, deep_delta=delta)
        torch.testing.assert_close(resumed, plain, atol=1e-6, rtol=0)
    assert torch.equal(delta, torch.zeros_like(delta))


def test_reuse_is_eval_only(model):
    x2d, x3d = torch.zeros(1, F, J, 2), torch.zeros(1, F, J, 3)
    t = torch.zeros(1, dtype=torch.long)
    for kw in (dict(reuse_tap=1, train=True), dict(reuse_tap=0),
               dict(reuse_tap=SMALL["depth"] + 1), dict(deep_delta=torch.zeros(1))):
        with pytest.raises(ValueError):
            model(x2d, x3d, t, **kw)


@pytest.mark.parametrize("level", [0, 4])
def test_full_call_matches_jax(rng, level):
    """The port's (output, delta) of a full call at tap 1 against JAX's."""
    jcfg = JMixSTEConfig(**SMALL, attention_impl="pallas", fuse_level=level)
    params = random_params(jcfg, seed=1)
    x2d = rng.randn(B, F, J, 2).astype(np.float32)
    x3d = rng.randn(B, F, J, 3).astype(np.float32)
    t = rng.randint(0, 1000, (B,)).astype(np.int32)
    want = JMixSTE2(jcfg).apply({"params": params}, x2d, x3d, t, reuse_tap=1)
    got = port_model(params, **SMALL, fuse_level=level)(*_t(x2d, x3d, t), reuse_tap=1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


# (reuse_interval, reuse_tap, reuse_tau) at K=4: fixed interval 2 (steps 0, 2
# and 3 full); adaptive with a threshold every drift exceeds (every step
# full); adaptive with one no drift reaches (the fixed schedule)
REUSE_MODES = {"fixed": (2, 1, 0.0), "tau-tiny": (5, 1, 1e-9), "tau-huge": (2, 1, 1e9)}


@pytest.mark.parametrize("mode", list(REUSE_MODES))
@pytest.mark.parametrize("level", [0, 3, 4, 5])
def test_sample_with_reuse_matches_jax(rng, level, mode):
    H, K = 2, 4
    interval, tap, tau = REUSE_MODES[mode]
    jcfg = JMixSTEConfig(**SMALL, attention_impl="pallas", fuse_level=level)
    params = random_params(jcfg, seed=2)
    kw = dict(num_proposals=H, sampling_timesteps=K, reuse_interval=interval,
              reuse_tap=tap, reuse_tau=tau)
    jd = JD3DP(JD3DPConfig(model=jcfg, **kw))
    td = D3DP(D3DPConfig(model=MixSTEConfig(**SMALL, fuse_level=level), **kw),
              model=port_model(params, **SMALL, fuse_level=level))
    x2d = (rng.randn(B, F, J, 2) * 0.3).astype(np.float32)
    x2d_f = (rng.randn(B, F, J, 2) * 0.3).astype(np.float32)
    img0 = rng.randn(B, H, F, J, 3).astype(np.float32)
    steps = rng.randn(K, B, H, F, J, 3).astype(np.float32)
    want = np.asarray(jd.sample({"params": params}, jax.random.PRNGKey(0), x2d, x2d_f,
                                noise_override=(img0, steps)))
    got = td.sample(*_t(x2d, x2d_f), noise_override=(img0, steps)).numpy()
    assert got.shape == (B, K, H, F, J, 3)
    np.testing.assert_allclose(got, want, atol=5e-4)
    if mode == "fixed":
        # the reuse steps engaged: the exact sampler differs
        exact = D3DP(dataclasses.replace(td.cfg, reuse_interval=1), model=td.model)
        assert not np.allclose(exact.sample(*_t(x2d, x2d_f),
                                            noise_override=(img0, steps)).numpy(), got)


def test_run_evaluation_with_reuse_matches_jax(tmp_path):
    """--ddim-reuse 2 at K=3: steps 0 and 2 full, step 1 reused from the
    first of the depth's two block pairs."""
    run_evaluation_against_jax(tmp_path, 4, K=3,
                               extra=("--ddim-reuse", "2", "--ddim-reuse-tap", "1"),
                               reuse_interval=2, reuse_tap=1)

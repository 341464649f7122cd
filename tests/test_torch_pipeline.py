"""The port's evaluation pipeline against the JAX package's, on the CPU:
synthetic data, then the whole Evaluator with replayed noise, all four
modes, Protocol 1 and 2, within 3.1e-4 mm (the whole-pipeline tolerance
the JAX suite holds against the original PyTorch code)."""

import jax
import numpy as np
import pytest
import torch

from d3dp_tpu.data import synthetic as jsyn
from d3dp_tpu.data.generators import UnchunkedGenerator as JGen
from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.eval import Evaluator as JEvaluator
from d3dp_tpu.models import MixSTEConfig as JMixSTEConfig
from d3dp_tpu_torch.data import synthetic as tsyn
from d3dp_tpu_torch.data.generators import UnchunkedGenerator
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.eval import MODES, Evaluator
from tests.test_torch_model import port_model, random_params

torch.set_num_threads(1)

F, H, K = 27, 2, 2
CFG = dict(num_frames=F, num_joints=17, embed_dim=64, depth=2, num_heads=8)
LR = dict(kps_left=list(jsyn.JOINTS_LEFT), kps_right=list(jsyn.JOINTS_RIGHT))
GEN_LR = dict(LR, joints_left=list(jsyn.JOINTS_LEFT), joints_right=list(jsyn.JOINTS_RIGHT))


@pytest.mark.parametrize("lengths", [(100, 80), (300, 250, 400, 486, 729)])
def test_synthetic_dataset_matches_jax(lengths):
    for t_list, j_list in zip(tsyn.make_dataset(seed=3, lengths=lengths),
                              jsyn.make_dataset(seed=3, lengths=lengths)):
        for a, b in zip(t_list, j_list):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def _provider(seed=11):
    rng = np.random.RandomState(seed)

    def provider(n):
        img0 = rng.randn(4, H, F, 17, 3).astype(np.float32)
        steps = rng.randn(K, 4, H, F, 17, 3).astype(np.float32)
        return img0[:n].copy(), steps[:, :n].copy()
    return provider


def test_evaluator_matches_jax():
    """100 + 80 frames at F=27: 4 + 3 windows, the second micro-batch padded
    to 4 with weight 0. Weights of std 0.02 keep the untrained model's
    errors at a few hundred mm, where fp32 summation order alone stays
    inside the tolerance."""
    jcfg = JMixSTEConfig(**CFG)
    params = random_params(jcfg, seed=4, scale=0.02)
    dkw = dict(num_proposals=H, sampling_timesteps=K, joints_left=tuple(jsyn.JOINTS_LEFT),
               joints_right=tuple(jsyn.JOINTS_RIGHT))
    data = jsyn.make_dataset(seed=1, lengths=(100, 80))
    ekw = dict(receptive_field=F, batch_size=4, p2=True, **LR)

    jev = JEvaluator(JD3DP(JD3DPConfig(model=jcfg, **dkw)), **ekw)
    want = jev.evaluate({"params": params}, JGen(*data, **GEN_LR), jax.random.PRNGKey(0),
                        noise_provider=_provider())
    tev = Evaluator(D3DP(D3DPConfig(model=tsyn_cfg(), **dkw), model=port_model(params, **CFG)),
                    **ekw)
    got = tev.evaluate(UnchunkedGenerator(*data), noise_provider=_provider())

    assert got.n == want.n == (4 + 3) * F
    for read in ("averages_mm", "averages_p2_mm"):
        g, w = getattr(got, read)(), getattr(want, read)()
        assert set(g) == set(w) == set(MODES)
        for m in MODES:
            assert g[m].shape == (K,) and np.isfinite(g[m]).all()
            np.testing.assert_allclose(g[m], w[m], atol=3.1e-4, rtol=0, err_msg=f"{read} {m}")
    p1 = got.averages_mm()
    assert np.all(p1["J_Best"] <= p1["P_Best"] + 1e-9)


def tsyn_cfg():
    from d3dp_tpu_torch.models import MixSTEConfig
    return MixSTEConfig(**CFG)


def test_evaluator_draws_noise_from_the_generator():
    """Without a noise provider the sampler draws from the torch.Generator
    passed in: the same seed gives the same metrics, another seed others."""
    td = D3DP(D3DPConfig(model=tsyn_cfg(), num_proposals=H, sampling_timesteps=K),
              device="cpu")
    ev = Evaluator(td, receptive_field=F, batch_size=4, p2=True, **LR)
    data = tsyn.make_dataset(seed=1, lengths=(100, 80))

    def run(seed):
        res = ev.evaluate(UnchunkedGenerator(*data), torch.Generator().manual_seed(seed))
        return res.averages_mm(), res.averages_p2_mm()
    a, b, c = run(0), run(0), run(1)
    for m in MODES:
        for i in (0, 1):
            assert np.isfinite(a[i][m]).all() and np.array_equal(a[i][m], b[i][m])
        assert not np.array_equal(a[0][m], c[0][m])
    assert np.all(a[0]["J_Best"] <= a[0]["P_Best"] + 1e-9)

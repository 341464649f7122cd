"""Fuse level 5 (the depth-resident trunk, K9) against the JAX package, on
the CPU: `resident_block_stack_plain` against the Pallas kernel in
interpret mode (fp32, atol 2e-5, the ops tolerance), MixSTE2 at level 5
against JAX's (atol 1e-4, tests/test_mixste.py), the sampler at level 5
with injected noise (atol 5e-4, the DDIM replay tolerance) and the command
line's evaluation at `--fuse-level 5` (3.1e-4 mm); and the port's level 5
against its own level 4, which it must equal exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.models import MixSTE2 as JMixSTE2, MixSTEConfig as JMixSTEConfig
from d3dp_tpu.ops.resident import resident_block_stack as j_resident
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig
from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.ops import mlp as tmlp
from d3dp_tpu_torch.ops import resident as tres
from tests.test_torch_cli import run_evaluation_against_jax
from tests.test_torch_model import SMALL, port_model, random_params

torch.set_num_threads(1)


def _t(*arrs):
    return [torch.from_numpy(a) for a in arrs]


def _stack_inputs(rng, B=2, F=9, J=5, C=32, H=64, D=2):
    """x, tpos, the two kinds' stacked weights and the shared norms, as
    numpy fp32 in `resident_block_stack`'s layouts."""
    def kind():
        vec = 0.05 * rng.randn(D, 6, C)
        vec[:, 1] += 1.0  # ln1 scale
        vec[:, 3] += 1.0  # ln2 scale
        return [a.astype(np.float32) for a in (
            rng.randn(D, C, 3 * C) * 0.1, rng.randn(D, 1, 3 * C) * 0.05,
            rng.randn(D, C, C) * 0.1, rng.randn(D, C, H) * 0.1, rng.randn(D, 1, H) * 0.05,
            rng.randn(D, H, C) * 0.1, vec)]
    shared = (0.05 * rng.randn(4, C) + np.array([1.0, 0.0, 1.0, 0.0])[:, None])
    return (rng.randn(B, F, J, C).astype(np.float32), (0.1 * rng.randn(F, C)).astype(np.float32),
            kind(), kind(), shared.astype(np.float32))


def test_resident_plain_matches_pallas(rng):
    x, tpos, sp, tp, shared = _stack_inputs(rng)
    heads, scale = 4, 8 ** -0.5
    want = np.asarray(j_resident(x, tpos, tuple(sp), tuple(tp), shared, heads, scale, 1e-6,
                                 interpret=True))
    n0 = tres.resident_block_stack.launches
    got = tres.resident_block_stack(*_t(x, tpos), _t(*sp), _t(*tp), *_t(shared), heads, scale,
                                    1e-6)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    # on the CPU the op runs its plain version: no launch
    assert tres.resident_block_stack.launches == n0


def test_mixste_level_5_matches_jax(rng):
    jcfg = JMixSTEConfig(**SMALL, attention_impl="pallas", fuse_level=5)
    params = random_params(jcfg, seed=1)
    B, F, J = 3, 9, 17
    x2d = rng.randn(B, F, J, 2).astype(np.float32)
    x3d = rng.randn(B, F, J, 3).astype(np.float32)
    t = rng.randint(0, 1000, (B,)).astype(np.int32)
    want = np.asarray(JMixSTE2(jcfg).apply({"params": params}, x2d, x3d, t))
    got = port_model(params, **SMALL, fuse_level=5)(*_t(x2d, x3d, t)).numpy()
    assert got.shape == (B, F, J, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_level_5_equals_level_4(rng, dtype):
    """Level 5 runs level 4's ops in level 4's order with its roundings
    (the tpos add included): the outputs are equal, not just close."""
    model = MixSTE2(MixSTEConfig(**SMALL, dtype=dtype), device="cpu", seed=3)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) * 0.05)
    x2d, x3d = _t(rng.randn(2, 9, 17, 2).astype(np.float32),
                  rng.randn(2, 9, 17, 3).astype(np.float32))
    t = torch.tensor([5, 900])
    outs = []
    for level in (4, 5):
        model.cfg = dataclasses.replace(model.cfg, fuse_level=level)
        outs.append(model(x2d, x3d, t))
    assert torch.equal(outs[0], outs[1])
    # the per-block weights of levels 1-4 are views into the stacks level 5 reads
    W = model._weights()
    assert W["ste"][1]["wqkv"].data_ptr() == W["resident"][0][0][1].data_ptr()
    assert W["tte"][0]["b2"].data_ptr() == W["resident"][1][6][0, 5].data_ptr()


def test_level_5_training_takes_the_composed_path(rng):
    """train=True at level 5 runs the composed block with autograd (the
    resident kernel has no backward, as in JAX): finite gradients for every
    parameter and no kernel op reached."""
    model = MixSTE2(MixSTEConfig(**SMALL, fuse_level=5, drop_path_rate=0.1), device="cpu")
    x2d, x3d = _t(rng.randn(2, 9, 17, 2).astype(np.float32),
                  rng.randn(2, 9, 17, 3).astype(np.float32))
    ops = (tres.resident_block_stack, tattn.attention_stage, tmlp.mlp_block_t)
    n0 = [f.launches for f in ops]
    out = model(x2d, x3d, torch.tensor([3, 400]), train=True,
                generator=torch.Generator().manual_seed(0))
    (out ** 2).sum().backward()
    grads = [p.grad for p in model.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert any(g.abs().sum() > 0 for g in grads)
    assert [f.launches for f in ops] == n0


def test_sample_level_5_matches_jax(rng):
    B, H, K, F, J = 2, 2, 3, 9, 17
    jcfg = JMixSTEConfig(**SMALL, attention_impl="pallas", fuse_level=5)
    params = random_params(jcfg, seed=2)
    kw = dict(num_proposals=H, sampling_timesteps=K)
    jd = JD3DP(JD3DPConfig(model=jcfg, **kw))
    td = D3DP(D3DPConfig(model=MixSTEConfig(**SMALL, fuse_level=5), **kw),
              model=port_model(params, **SMALL, fuse_level=5))
    x2d = (rng.randn(B, F, J, 2) * 0.3).astype(np.float32)
    x2d_f = (rng.randn(B, F, J, 2) * 0.3).astype(np.float32)
    img0 = rng.randn(B, H, F, J, 3).astype(np.float32)
    steps = rng.randn(K, B, H, F, J, 3).astype(np.float32)
    want = np.asarray(jd.sample({"params": params}, jax.random.PRNGKey(0), x2d, x2d_f,
                                noise_override=(img0, steps)))
    got = td.sample(*_t(x2d, x2d_f), noise_override=(img0, steps)).numpy()
    assert got.shape == (B, K, H, F, J, 3)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_run_evaluation_level_5_matches_jax(tmp_path):
    run_evaluation_against_jax(tmp_path, 5)


@pytest.mark.parametrize("B,F,J,sms,want", [
    (40, 243, 17, 132, 20),      # the eval shape: 33 rows give 16 waves; two even groups
    (40, 243, 17, 66, 14),       # half the SMs: 17 rows, so three groups of at most 14
    (2, 9, 5, 132, 2),           # never more than B
    (40, 27, 17, 132, 40),       # short windows: all rows in one group
    (10240, 243, 17, 132, 33),   # 1024 padded windows x H=5 x flip: 311 groups of 33
])
def test_group_rows(B, F, J, sms, want):
    """Rows a K9 group takes: enough for WAVES waves of 64-row tiles in
    every GEMM phase on `sms` SMs, at most B, balanced over the groups."""
    G = tres.group_rows(B, F, J, sms)
    assert G == want
    groups = -(-B // G)
    assert G * groups >= B and G * (groups - 1) < B
    if G < B:
        assert G * F * J >= tres.WAVES * sms * tres.TILE_ROWS * (groups - 1) / groups

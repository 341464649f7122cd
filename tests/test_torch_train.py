"""The port's training step against the JAX package's, on the CPU.

The attention core and its backward (plain torch versions here; the CUDA
kernels are held against them on the card in tests/test_torch_kernels.py)
against the JAX Pallas kernels in interpret mode; the training forward's
loss and every gradient against `jax.value_and_grad`, with the same weights,
t, noise and DropPath masks injected; AdamW against optax; and the weight
cache after a step. The training data path and light validation are in
tests/test_torch_train_data.py.

Tolerances: attention fp32 2e-5 (forward) and 3e-4 (backward), as
tests/test_pallas_ops.py holds the kernels; bf16 one bf16 ulp of the value
plus an absolute 1e-3 (forward) or 2e-3 (backward): both versions round at
the same places, but a probability (or dS) whose rounding is flipped by the
fp32 summation order moves the output by one ulp of that probability times
|v| (or |k|, |q|), which near an output of 0 is many of its own ulps (seen:
6e-5 forward, 3e-4 backward beyond the ulp); loss and gradients 2e-4 (the
model's full-size tolerance, tests/test_pallas_ops.py:105); bf16 gradients
by direction, cosine >= 0.999 per parameter, since bf16 rounds at other
places in the two frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.models import MixSTEConfig as JMixSTEConfig
from d3dp_tpu.models.mixste import Block as JBlock
from d3dp_tpu.ops.attention import _fused_attention_qkv_bwd, fused_attention_qkv
from d3dp_tpu.train import state as jstate
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.models import MixSTEConfig
from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from d3dp_tpu_torch.train.state import (get_lr, make_optimizer, make_train_step, set_lr,
                                        weighted_mpjpe)
from tests.test_torch_model import SMALL, port_model, random_params

torch.set_num_threads(1)

DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
B, F, J = 3, 9, 17
LR_TRAIN = 6e-5


def _bf16_ulp(x):
    """One bf16 ulp of |x| (8 significant bits)."""
    return 2.0 ** (np.frexp(np.abs(x))[1] - 8)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


# ------------------------------------------------------- attention core
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# the train step's shapes, and the card tiles' edges (a warp a tile at 32
# keys or fewer; 64, 128 and 256 keys a block tile)
@pytest.mark.parametrize("R,N", [(16, 17), (4, 243), (2, 1), (2, 33), (2, 65), (1, 256)])
def test_attention_qkv_plain_matches_jax(rng, R, N, dtype):
    qkv = rng.randn(R, N, 3 * 512).astype(np.float32)
    dout = rng.randn(R, N, 512).astype(np.float32)
    jq, jd = jnp.asarray(qkv).astype(DTYPES[dtype]), jnp.asarray(dout).astype(DTYPES[dtype])
    tq, td = torch.from_numpy(qkv).to(dtype), torch.from_numpy(dout).to(dtype)

    want = _np(fused_attention_qkv(jq, 8, 0.125, interpret=True))
    got = tattn.fused_attention_qkv_plain(tq, 8, 0.125)
    assert got.dtype == dtype and tuple(got.shape) == (R, N, 512)
    wantb = _np(_fused_attention_qkv_bwd(jq, jd, 8, 0.125, interpret=True))
    gotb = tattn.fused_attention_qkv_bwd_plain(tq, td, 8, 0.125)
    assert gotb.dtype == dtype and tuple(gotb.shape) == (R, N, 3 * 512)
    got, gotb = got.float().numpy(), gotb.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
        np.testing.assert_allclose(gotb, wantb, atol=3e-4, rtol=0)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-3)
        assert np.all(np.abs(gotb - wantb) <= _bf16_ulp(wantb) + 2e-3)


@pytest.mark.parametrize("R,N", [(6, 17), (2, 30)])
def test_attention_qkv_ad_grad_matches_autograd_of_plain(rng, R, N):
    """The autograd.Function's backward (the K4 route) against torch.autograd
    through the plain forward, fp32."""
    qkv = torch.from_numpy(rng.randn(R, N, 3 * 64).astype(np.float32))
    dout = torch.from_numpy(rng.randn(R, N, 64).astype(np.float32))
    a = qkv.clone().requires_grad_(True)
    b = qkv.clone().requires_grad_(True)
    out = tattn.fused_attention_qkv_ad(a, 8, 0.35)
    torch.testing.assert_close(out, tattn.fused_attention_qkv_plain(qkv, 8, 0.35),
                               atol=0, rtol=0)
    (ga,) = torch.autograd.grad(out, a, dout)
    (gb,) = torch.autograd.grad(tattn.fused_attention_qkv_plain(b, 8, 0.35), b, dout)
    np.testing.assert_allclose(ga.numpy(), gb.numpy(), atol=3e-4, rtol=0)


def test_cpu_attention_qkv_wrappers_run_plain_and_count_no_launch(rng):
    n_f, n_b = tattn.fused_attention_qkv.launches, tattn.fused_attention_qkv_bwd.launches
    qkv = torch.from_numpy(rng.randn(3, 17, 192).astype(np.float32))
    dout = torch.from_numpy(rng.randn(3, 17, 64).astype(np.float32))
    assert torch.equal(tattn.fused_attention_qkv(qkv, 8, 0.35),
                       tattn.fused_attention_qkv_plain(qkv, 8, 0.35))
    assert torch.equal(tattn.fused_attention_qkv_bwd(qkv, dout, 8, 0.35),
                       tattn.fused_attention_qkv_bwd_plain(qkv, dout, 8, 0.35))
    assert (tattn.fused_attention_qkv.launches, tattn.fused_attention_qkv_bwd.launches) == \
        (n_f, n_b)


# ------------------------------------------------------- train forward
def _batch(seed):
    r = np.random.RandomState(seed)
    x2d = (r.randn(B, F, J, 2) * 0.3).astype(np.float32)
    x3d = (r.randn(B, F, J, 3) * 0.3).astype(np.float32)
    x3d[:, :, 0] = 0.0  # root-zeroed, as the train step feeds it
    t = r.randint(0, 1000, (B,)).astype(np.int32)
    noise = r.randn(B, F, J, 3).astype(np.float32)
    return x2d, x3d, t, noise


WEIGHTS = np.array([1.0, 1.0, 0.0], np.float32)  # the last row is padding


def _droppath_masks(cfg, seed):
    """Per-block numpy masks for every block whose rate is above 0, with at
    least one dropped row each."""
    r = np.random.RandomState(seed)
    rates = np.linspace(0, cfg["drop_path_rate"], cfg["depth"])
    out = {}
    for i, rate in enumerate(rates):
        if rate <= 0:
            continue
        keep = 1.0 - rate
        for kind, rows in (("ste", B * F), ("tte", B * J)):
            ms = []
            for _ in range(2):
                m = np.where(r.rand(rows) < keep, 1.0 / keep, 0.0).astype(np.float32)
                m[0] = 0.0
                ms.append(m)
            out[f"{kind}_{i}"] = tuple(ms)
    return out


def _jax_loss_and_grads(params, cfg, impl, batch, masks, monkeypatch, dtype=jnp.float32,
                        train=True):
    x2d, x3d, t, noise = batch
    jd = JD3DP(JD3DPConfig(model=JMixSTEConfig(**cfg, attention_impl=impl, dtype=dtype)))
    if masks:
        monkeypatch.setattr(JBlock, "_droppath_masks",
                            lambda self, n: tuple(jnp.asarray(m) for m in masks[self.name]))

    def loss_fn(p):
        pred = jd.train_forward({"params": p}, jax.random.PRNGKey(0), x2d, x3d, train=train,
                                t_noise_override=(t, noise))
        return jstate.weighted_mpjpe(pred, x3d, WEIGHTS)
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _port_loss_and_grads(params, cfg, batch, masks, dtype=torch.float32, train=True):
    x2d, x3d, t, noise = batch
    model = port_model(params, **cfg, dtype=dtype)
    td = D3DP(D3DPConfig(model=model.cfg), model=model)
    pred = td.train_forward(x2d, x3d, train=train, t_noise_override=(t, noise),
                            droppath_masks=masks)
    loss = weighted_mpjpe(pred, torch.from_numpy(x3d), torch.from_numpy(WEIGHTS))
    loss.backward()
    return float(loss), {n: p.grad.numpy() for n, p in model.named_parameters()}


@pytest.mark.parametrize("impl,rate", [("pallas", 0.0), ("xla", 0.0), ("pallas", 0.1)])
def test_train_forward_loss_and_grads_match_jax(impl, rate, monkeypatch):
    """fp32: the composed training path with autograd against
    jax.value_and_grad of the JAX train_forward + weighted_mpjpe. At rate 0.1
    the JAX blocks get the port's masks through a patched
    `Block._droppath_masks`."""
    cfg = dict(SMALL, drop_path_rate=rate)
    params = random_params(JMixSTEConfig(**SMALL), seed=3)
    batch = _batch(4)
    masks = _droppath_masks(cfg, 5) if rate else None
    jloss, jgrads = _jax_loss_and_grads(params, cfg, impl, batch, masks, monkeypatch)
    tloss, tgrads = _port_loss_and_grads(params, cfg, batch, masks)
    want = state_dict_from_flax(jgrads, cfg["depth"])
    assert set(tgrads) == set(want)
    assert abs(tloss - jloss) <= 2e-4 * abs(jloss)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g, want[name].numpy(), atol=2e-4, rtol=0, err_msg=name)
    if masks:
        # the masks matter: without them the loss moves
        tloss0, _ = _port_loss_and_grads(params, cfg, batch,
                                         {k: (np.ones_like(a), np.ones_like(b))
                                          for k, (a, b) in masks.items()})
        assert abs(tloss0 - tloss) > 1e-4


def test_train_forward_deterministic_matches_jax(monkeypatch):
    """train=False at drop_path_rate 0.1: JAX runs the fused stages with
    their custom backward (Pallas, interpret mode), the port the composed
    path without DropPath; loss and every gradient within 2e-4, and no
    generator is needed."""
    cfg = dict(SMALL, drop_path_rate=0.1)
    params = random_params(JMixSTEConfig(**SMALL), seed=3)
    batch = _batch(4)
    jloss, jgrads = _jax_loss_and_grads(params, cfg, "pallas", batch, None, monkeypatch,
                                        train=False)
    tloss, tgrads = _port_loss_and_grads(params, cfg, batch, None, train=False)
    want = state_dict_from_flax(jgrads, cfg["depth"])
    assert set(tgrads) == set(want)
    assert abs(tloss - jloss) <= 2e-4 * abs(jloss)
    for name, g in tgrads.items():
        np.testing.assert_allclose(g, want[name].numpy(), atol=2e-4, rtol=0, err_msg=name)


def _cos(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return a @ b / (np.linalg.norm(a) * np.linalg.norm(b))


# The leaves whose JAX bf16 gradient is itself further than cosine 0.999
# from the fp32 gradient: the spatial blocks' qkv biases, whose gradient JAX
# sums over all B*F*J rows in bf16 (torch sums in fp32).
BF16_NOISY_IN_JAX = {"STEblocks.0.attn.qkv.bias", "STEblocks.1.attn.qkv.bias"}


def test_train_forward_bf16_grads_point_the_same_way(monkeypatch):
    """bf16 compute, fp32 parameters: every gradient within cosine 0.999 of
    JAX's bf16 gradient, except the leaves of BF16_NOISY_IN_JAX, which must
    be exactly those below 0.999 and must instead lie at least as close to
    the fp32 gradient as JAX's, and within 0.999 of it. (The fp32 gradient
    is the port's, held to JAX's within 2e-4 above.)"""
    params = random_params(JMixSTEConfig(**SMALL), seed=3)
    batch = _batch(6)
    jloss, jgrads = _jax_loss_and_grads(params, SMALL, "pallas", batch, None, monkeypatch,
                                        dtype=jnp.bfloat16)
    tloss, tgrads = _port_loss_and_grads(params, SMALL, batch, None, dtype=torch.bfloat16)
    _, want32 = _port_loss_and_grads(params, SMALL, batch, None)
    want = state_dict_from_flax(jgrads, SMALL["depth"])
    assert abs(tloss - jloss) <= 1e-2 * abs(jloss)
    fallback = {name for name, g in tgrads.items() if _cos(g, want[name]) < 0.999}
    assert fallback == BF16_NOISY_IN_JAX
    for name in fallback:
        ref = _cos(want[name], want32[name])
        assert ref < 0.999 and _cos(tgrads[name], want32[name]) >= max(0.999, ref), (name, ref)


def test_train_forward_needs_explicit_randomness():
    td = D3DP(D3DPConfig(model=MixSTEConfig(**SMALL, drop_path_rate=0.1)), device="cpu")
    x2d, x3d, t, noise = _batch(7)
    with pytest.raises(ValueError):
        td.train_forward(x2d, x3d)
    with pytest.raises(ValueError, match="DropPath"):
        td.train_forward(x2d, x3d, t_noise_override=(t, noise))
    a = td.train_forward(x2d, x3d, generator=torch.Generator().manual_seed(0))
    b = td.train_forward(x2d, x3d, generator=torch.Generator().manual_seed(0))
    c = td.train_forward(x2d, x3d, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c) and torch.isfinite(a).all()


# ------------------------------------------------------------ optimizer
def test_adamw_steps_match_optax():
    """Three full train steps (fp32, xla composed path on the JAX side): the
    port's make_train_step against optax's AdamW on JAX's gradients of the
    same batches."""
    params = random_params(JMixSTEConfig(**SMALL), seed=8)
    jd = JD3DP(JD3DPConfig(model=JMixSTEConfig(**SMALL)))
    tx = jstate.make_optimizer(LR_TRAIN)
    opt_state = tx.init(params)

    @jax.jit
    def jstep(p, s, x2d, x3d, t, noise):
        x3d = x3d.at[:, :, 0].set(0.0)

        def loss_fn(q):
            pred = jd.train_forward({"params": q}, jax.random.PRNGKey(0), x2d, x3d,
                                    train=True, t_noise_override=(t, noise))
            return jstate.weighted_mpjpe(pred, x3d, WEIGHTS)
        loss, g = jax.value_and_grad(loss_fn)(p)
        upd, s = tx.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    model = port_model(params, **SMALL)
    td = D3DP(D3DPConfig(model=model.cfg), model=model)
    opt = make_optimizer(model.parameters(), LR_TRAIN)
    step = make_train_step(td, opt)
    for i in range(3):
        x2d, x3d, t, noise = _batch(10 + i)
        x3d[:, :, 0] = 0.7  # a trajectory in the root joint: the step zeroes it
        params, opt_state, jloss = jstep(params, opt_state, x2d, x3d, t, noise)
        tloss = step(x2d, x3d, WEIGHTS, t_noise_override=(t, noise))
        assert tloss.shape == () and tloss.device.type == "cpu"
        assert abs(float(tloss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), SMALL["depth"])
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), atol=3 * LR_TRAIN, rtol=0,
                                   err_msg=name)
    assert get_lr(opt) == LR_TRAIN
    set_lr(opt, LR_TRAIN * 0.99)
    assert get_lr(opt) == pytest.approx(LR_TRAIN * 0.99)
    jstate.set_lr(opt_state, LR_TRAIN * 0.99)
    assert jstate.get_lr(opt_state) == pytest.approx(get_lr(opt))


def test_loss_falls_on_a_repeated_batch():
    td = D3DP(D3DPConfig(model=MixSTEConfig(**SMALL)), device="cpu")
    step = make_train_step(td, make_optimizer(td.model.parameters(), 3e-4))
    x2d, x3d, t, noise = _batch(12)
    losses = [float(step(x2d, x3d, np.ones(B, np.float32), t_noise_override=(t, noise)))
              for _ in range(10)]
    assert all(np.isfinite(losses)) and losses[-1] < 0.9 * losses[0], losses


# ------------------------------------------------ weight cache after a step
def test_sampling_after_a_train_step_uses_the_trained_weights():
    """The eval path's cast-weight cache follows in-place optimizer updates:
    sampling after a step equals sampling with a fresh model loaded from the
    trained state_dict."""
    cfg = MixSTEConfig(**SMALL)
    dkw = dict(num_proposals=2, sampling_timesteps=2)
    td = D3DP(D3DPConfig(model=cfg, **dkw), device="cpu", seed=1)
    r = np.random.RandomState(13)
    x2d = torch.from_numpy((r.randn(2, F, J, 2) * 0.3).astype(np.float32))
    noise = (r.randn(2, 2, F, J, 3).astype(np.float32),
             r.randn(2, 2, 2, F, J, 3).astype(np.float32))
    before = td.sample(x2d, x2d, noise_override=noise)  # builds the cache
    step = make_train_step(td, make_optimizer(td.model.parameters(), 1e-3))
    x2d_b, x3d_b, t, n = _batch(14)
    step(x2d_b, x3d_b, np.ones(B, np.float32), t_noise_override=(t, n))
    after = td.sample(x2d, x2d, noise_override=noise)

    fresh = D3DP(D3DPConfig(model=cfg, **dkw), device="cpu", seed=2)
    fresh.model.load_state_dict(td.model.state_dict())
    want = fresh.sample(x2d, x2d, noise_override=noise)
    assert not torch.equal(after, before)
    assert torch.equal(after, want)

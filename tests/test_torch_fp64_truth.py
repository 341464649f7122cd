"""The fp32 evaluation paths against a float64 truth (tests/fp64_truth.py),
on the CPU.

First the truth itself against the JAX package in fp32, at
tests/test_torch_pipeline.py's configuration (C=64, depth 2, F=27, H=2,
K=2), at the tolerances the suite holds: the model 1e-4, the DDIM replay
5e-4, the Evaluator's four modes 3.1e-4 mm.

Then the distance from the truth of three fp32 paths, per mode and per
DDIM step, on the Evaluator's micro-batches:
  * "jax": the JAX package's jitted eval step (plain XLA, level-0 math);
  * "port0", "port4": the port in one process at fuse levels 0 and 4 (the
    plain versions of the kernels on the CPU), its `sample` and `_score`;
  * "tp2": level 4's tensor-parallel split as the port ran it before its
    evaluation took the gathered weights: each block half's plain partial
    form on two ranks' shares, summed as two fp32 halves, then
    `residual_ln` (`TPSplit`).
Each path's distance is also taken apart: how many of its P-Best and JPMA
selections differ from the truth's, and the modes with the truth's
selections (the drift in the predictions alone; a flip at a near-tie is a
discontinuity of the mode, not drift).

The rule, written before the readings at full width: the port's one-process
distance from the truth, the maximum over modes and steps, is at most
twice JAX's plus 3.1e-4 mm. Tier-1 holds it at C=256, depth 2
(tests/test_torch_tp_ranks.py's configuration and weights); the slow cases
at the published width (C=512, 8 heads, hidden 1024, F=243) at depths 4 and
8 on one window. Run with `-s` to print each case's readings as one JSON
line.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from d3dp_tpu.data import synthetic as jsyn
from d3dp_tpu.data.generators import UnchunkedGenerator as JGen
from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.eval import Evaluator as JEvaluator
from d3dp_tpu.models import MixSTE2 as JMixSTE2, MixSTEConfig as JMixSTEConfig
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.eval import Evaluator
from d3dp_tpu_torch.models import MixSTEConfig
from d3dp_tpu_torch.models.mixste import BLOCK_EPS, sinusoidal_time_embedding
from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.ops import mlp as tmlp
from d3dp_tpu_torch.ops.residual_ln import residual_ln
from d3dp_tpu_torch.parallel.mesh import split_state_dict
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from tests import fp64_truth as T
from tests.test_torch_model import port_model, random_params

torch.set_num_threads(1)

LR = dict(kps_left=list(jsyn.JOINTS_LEFT), kps_right=list(jsyn.JOINTS_RIGHT))
GEN_LR = dict(LR, joints_left=list(jsyn.JOINTS_LEFT), joints_right=list(jsyn.JOINTS_RIGHT))
SYM = dict(joints_left=tuple(jsyn.JOINTS_LEFT), joints_right=tuple(jsyn.JOINTS_RIGHT))
H, K = 2, 2
SMALL = dict(num_frames=27, num_joints=17, embed_dim=64, depth=2, num_heads=8)
TP_RANKS = dict(num_frames=27, num_joints=17, embed_dim=256, depth=2, num_heads=4)
PIPELINE_TOL_MM = 3.1e-4


def provider(seed, bs, F):
    """noise_provider(n): a seeded stream, one micro-batch of bs rows a call,
    the first n returned (tests/test_torch_pipeline.py's)."""
    rng = np.random.RandomState(seed)

    def fn(n):
        img0 = rng.randn(bs, H, F, 17, 3).astype(np.float32)
        steps = rng.randn(K, bs, H, F, 17, 3).astype(np.float32)
        return img0[:n].copy(), steps[:, :n].copy()
    return fn


def perm():
    return T.lr_perm(17, jsyn.JOINTS_LEFT, jsyn.JOINTS_RIGHT)


# ------------------------------------------------ the truth against JAX fp32
@pytest.fixture(scope="module")
def small():
    params = random_params(JMixSTEConfig(**SMALL), seed=4, scale=0.02)
    return params, T.weights64(state_dict_from_flax(params, SMALL["depth"]))


def test_truth_model_matches_jax(small, rng):
    params, P = small
    B, F = 3, SMALL["num_frames"]
    x2d = (rng.randn(B, F, 17, 2) * 0.3).astype(np.float32)
    x3d = (rng.randn(B, F, 17, 3) * 0.3).astype(np.float32)
    t = rng.randint(0, 1000, (B,)).astype(np.int32)
    want = np.asarray(JMixSTE2(JMixSTEConfig(**SMALL)).apply(
        {"params": params}, jnp.asarray(x2d), jnp.asarray(x3d), jnp.asarray(t)))
    got = T.model(P, SMALL, *(torch.from_numpy(a).double() for a in (x2d, x3d)),
                  torch.from_numpy(t))
    assert got.dtype == torch.float64 and got.shape == (B, F, 17, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_truth_sample_matches_jax(small, rng):
    params, P = small
    B, F = 2, SMALL["num_frames"]
    x2d, x2d_f = ((rng.randn(B, F, 17, 2) * 0.3).astype(np.float32) for _ in range(2))
    img0 = rng.randn(B, H, F, 17, 3).astype(np.float32)
    steps = rng.randn(K, B, H, F, 17, 3).astype(np.float32)
    jd = JD3DP(JD3DPConfig(model=JMixSTEConfig(**SMALL), num_proposals=H,
                           sampling_timesteps=K, **SYM))
    want = np.asarray(jd.sample({"params": params}, jax.random.PRNGKey(0), x2d, x2d_f,
                                noise_override=(img0, steps)))
    got = T.sample(P, SMALL, x2d, x2d_f, img0, steps, perm())
    assert got.dtype == torch.float64 and got.shape == want.shape == (B, K, H, F, 17, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0)


def test_truth_evaluator_matches_jax(small):
    """tests/test_torch_pipeline.py's evaluation: 100 + 80 frames, 4 + 3
    windows, the second micro-batch padded to 4."""
    params, P = small
    F = SMALL["num_frames"]
    data = jsyn.make_dataset(seed=1, lengths=(100, 80))
    jev = JEvaluator(JD3DP(JD3DPConfig(model=JMixSTEConfig(**SMALL), num_proposals=H,
                                       sampling_timesteps=K, **SYM)),
                     receptive_field=F, batch_size=4, **LR)
    want = jev.evaluate({"params": params}, JGen(*data, **GEN_LR), jax.random.PRNGKey(0),
                        noise_provider=provider(11, 4, F)).averages_mm()
    batches = list(T.micro_batches(data, F, 4, LR["kps_left"], LR["kps_right"],
                                   provider(11, 4, F)))
    assert [b["n"] for b in batches] == [4, 3]
    got, _ = T.evaluate(P, SMALL, batches, perm())
    for m in T.MODES:
        assert got[m].shape == (K,) and got[m].dtype == np.float64
        np.testing.assert_allclose(got[m], want[m], atol=PIPELINE_TOL_MM, rtol=0, err_msg=m)


# ------------------------------------------------------- the fp32 paths
class TPSplit(torch.nn.Module):
    """The port's level-4 evaluation forward at tp=2 as it ran before its
    evaluation took the gathered weights, on one process: each block
    half's partial form (K1-tp, K2-tp; their plain versions on the CPU) on
    each rank's shares (`split_state_dict`), the two fp32 partials summed
    (the all-reduce of two ranks), then `residual_ln`; the time MLP's
    second layer summed the same way before its bias."""

    def __init__(self, model, tp=2):
        super().__init__()
        self.whole, self.tp = model, tp
        dt = model.cfg.dtype
        self.ranks = []
        for j in range(tp):
            R = split_state_dict(model.state_dict(), tp, j)

            def mat(name, R=R):
                return R[f"{name}.weight"].t().contiguous().to(dt)
            self.ranks.append(dict(
                time1=(R["time_mlp.1.weight"].to(dt), R["time_mlp.1.bias"].to(dt)),
                time2=R["time_mlp.3.weight"].to(dt),
                blocks={f"{kind}.{i}": dict(
                    wqkv=mat(f"{kind}.{i}.attn.qkv"), bqkv=R[f"{kind}.{i}.attn.qkv.bias"].float(),
                    wp=mat(f"{kind}.{i}.attn.proj"), w1=mat(f"{kind}.{i}.mlp.fc1"),
                    b1=R[f"{kind}.{i}.mlp.fc1.bias"].float(), w2=mat(f"{kind}.{i}.mlp.fc2"))
                    for kind in ("STEblocks", "TTEblocks") for i in range(model.cfg.depth)}))

    def forward(self, x2d, x3d, t):
        m, cfg = self.whole, self.whole.cfg
        dt, C, heads = cfg.dtype, cfg.embed_dim, cfg.num_heads // self.tp
        W = m._weights()
        B, Fr, J, _ = x3d.shape
        temb = sinusoidal_time_embedding(t, C).to(dt)
        part = sum(Fn.linear(Fn.gelu(Fn.linear(temb, *r["time1"]), approximate="none").float(),
                             r["time2"].float()) for r in self.ranks)
        temb = (part + W["time2"][1].float()).to(dt)
        x = Fn.linear(torch.cat([x2d, x3d], dim=-1).to(dt), *W["embed"])
        x = x + W["spatial_pos"] + temb[:, None, None, :]

        def half(w, name, h, norm):
            R, N, _ = h.shape
            rs = [r["blocks"][name] for r in self.ranks]
            part = sum(tattn.attention_stage_partial(h, r["wqkv"], r["bqkv"], w["ln1s"],
                                                     w["ln1b"], r["wp"], heads, cfg.attn_scale,
                                                     BLOCK_EPS).float() for r in rs)
            x2, y2 = residual_ln(h, part, w["bp"], w["ln2s"], w["ln2b"], BLOCK_EPS)
            part = sum(tmlp.mlp_block_partial(y2.reshape(R * N, C), r["w1"], r["b1"],
                                              r["w2"]).float() for r in rs)
            D1 = R // B
            out = residual_ln(x2.view(B, D1, N, C), part.view(B, D1, N, C), w["b2"], *norm,
                              BLOCK_EPS, with_x2=False, transpose=True)
            return out.view(B * N, D1, C)

        h = x.reshape(B * Fr, J, C)
        for i in range(cfg.depth):
            h = half(W["ste"][i], f"STEblocks.{i}", h, W["spatial_norm"])
            if i == 0:
                h = h + W["temporal_pos"]
            h = half(W["tte"][i], f"TTEblocks.{i}", h, W["temporal_norm"])
        return m._head(h.view(B, Fr, J, C))


def _jax_path(cfg, params, batches):
    jev = JEvaluator(JD3DP(JD3DPConfig(model=JMixSTEConfig(**cfg), num_proposals=H,
                                       sampling_timesteps=K, **SYM)),
                     receptive_field=cfg["num_frames"], batch_size=len(batches[0]["weights"]),
                     **LR)
    out = []
    for b in batches:
        errors, _, preds = jev._step_noise(
            {"params": params}, jax.random.PRNGKey(0), *(jnp.asarray(b[k]) for k in (
                "x2d", "x2d_flip", "x3d", "traj", "cam", "weights", "img0", "step_noises")),
            need_preds=True)
        out.append(({m: np.asarray(v, np.float64) for m, v in errors.items()},
                    np.asarray(preds)))
    return out


def _port_path(d3dp, batches):
    ev = Evaluator(d3dp, receptive_field=d3dp.cfg.model.num_frames,
                   batch_size=len(batches[0]["weights"]), **LR)
    out = []
    for b in batches:
        x = {k: torch.from_numpy(np.ascontiguousarray(b[k])) for k in (
            "x2d", "x2d_flip", "x3d", "traj", "cam", "weights")}
        preds = d3dp.sample(x["x2d"], x["x2d_flip"], noise_override=(b["img0"],
                                                                      b["step_noises"]))
        errors, _, _ = ev._score(preds, x["x2d"], x["x3d"], x["traj"], x["cam"], x["weights"])
        out.append(({m: v.double().numpy() for m, v in errors.items()}, preds.numpy()))
    return out


def readings(cfg, params, data, bs):
    """Each fp32 path's distance from the truth on the Evaluator's
    micro-batches of `data`: per mode and step (mm), the maximum, the
    predictions' largest distance (mm), the selection flips and the
    distance with the truth's selections."""
    F = cfg["num_frames"]
    t0 = time.perf_counter()
    batches = list(T.micro_batches(data, F, bs, LR["kps_left"], LR["kps_right"],
                                   provider(11, bs, F)))
    sd = state_dict_from_flax(params, cfg["depth"])
    truth, per_batch = T.evaluate(T.weights64(sd), cfg, batches, perm())
    seconds = {"truth": time.perf_counter() - t0}
    dkw = dict(num_proposals=H, sampling_timesteps=K, **SYM)
    paths = {"jax": lambda: _jax_path(cfg, params, batches)}
    for level in (0, 4):
        paths[f"port{level}"] = lambda level=level: _port_path(D3DP(
            D3DPConfig(model=MixSTEConfig(**cfg, fuse_level=level), **dkw),
            model=port_model(params, **cfg, fuse_level=level)), batches)
    paths["tp2"] = lambda: _port_path(D3DP(D3DPConfig(model=MixSTEConfig(**cfg), **dkw),
                                           model=TPSplit(port_model(params, **cfg))), batches)
    out = dict(truth_mm={m: v.tolist() for m, v in truth.items()}, paths={}, seconds=seconds)
    for name, run in paths.items():
        t0 = time.perf_counter()
        res = run()
        seconds[name] = time.perf_counter() - t0
        total = sum(b["n"] for b in batches)
        modes = {m: sum(e[m] * b["n"] for (e, _), b in zip(res, batches)) / total * 1000.0
                 for m in T.MODES}
        own, drift = ({m: 0.0 for m in T.MODES} for _ in range(2))
        flips = dict(p_best=0, jpma=0, jpma_picks=0)
        pred_mm = np.zeros(K)
        for (_, preds), b, tb in zip(res, batches, per_batch):
            n = b["n"]
            args = (b["x2d"][:n], b["x3d"][:n], b["traj"][:n], b["cam"][:n])
            mo, sel = T.score(preds[:n], *args)
            md, _ = T.score(preds[:n], *args, selections=tb["selections"])
            for m in T.MODES:
                own[m] = own[m] + mo[m] * n
                drift[m] = drift[m] + md[m] * n
            flips["p_best"] += int((sel["p_best"] != tb["selections"]["p_best"]).sum())
            flips["jpma"] += int((sel["jpma"] != tb["selections"]["jpma"]).sum())
            flips["jpma_picks"] += sel["jpma"].numel()
            diff = preds[:n] - tb["preds"].numpy()
            diff[..., 0, :] = 0.0  # the root, zeroed before scoring (JAX returns it so)
            pred_mm = np.maximum(pred_mm, np.abs(diff).max(axis=(0, 2, 3, 4, 5)) * 1000.0)
        gap = {m: np.abs(modes[m] - truth[m]) for m in T.MODES}
        out["paths"][name] = dict(
            gap_mm={m: v.tolist() for m, v in gap.items()},
            max_gap_mm=float(max(v.max() for v in gap.values())),
            pred_max_mm=pred_mm.tolist(), flips=flips,
            gap_f64_scoring_mm={m: np.abs(own[m] / total * 1000.0 - truth[m]).tolist()
                                for m in T.MODES},
            gap_truth_selections_mm={m: np.abs(drift[m] / total * 1000.0 - truth[m]).tolist()
                                     for m in T.MODES})
    return out


def hold_the_rule(r, tag):
    """The rule of the module docstring, on the port's levels 0 and 4."""
    print(json.dumps({"fp64_truth": tag, **r}))
    jax_gap = r["paths"]["jax"]["max_gap_mm"]
    for name in ("port0", "port4"):
        got = r["paths"][name]["max_gap_mm"]
        assert got <= 2 * jax_gap + PIPELINE_TOL_MM, (tag, name, got, jax_gap)
    for p in r["paths"].values():
        assert np.isfinite(p["max_gap_mm"])


def test_port_within_twice_jax_of_the_truth_at_c256():
    """tests/test_torch_tp_ranks.py's width and weights (std 0.02) on
    tests/test_torch_parallel.py's evaluation set: 100, 80 and 40 frames,
    4 + 3 + 2 windows in micro-batches of 4."""
    params = random_params(JMixSTEConfig(**TP_RANKS), seed=4, scale=0.02)
    r = readings(TP_RANKS, params, jsyn.make_dataset(seed=1, lengths=(100, 80, 40)), 4)
    hold_the_rule(r, "C=256 depth 2")


@pytest.mark.slow
@pytest.mark.parametrize("depth", [4, 8])
def test_port_within_twice_jax_of_the_truth_at_full_width(depth):
    """The published width (C=512, 8 heads, hidden 1024, F=243) at `depth`,
    one window (243 frames), weights of std 0.02."""
    cfg = dict(num_frames=243, num_joints=17, embed_dim=512, depth=depth, num_heads=8)
    params = random_params(JMixSTEConfig(**cfg), seed=4, scale=0.02)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        t0 = time.perf_counter()
        r = readings(cfg, params, jsyn.make_dataset(seed=1, lengths=(243,)), 1)
        r["seconds"]["case"] = time.perf_counter() - t0
    finally:
        torch.set_num_threads(threads)
    hold_the_rule(r, f"C=512 depth {depth}")

"""The port's tensor-parallel layer (`--tp`: parallel/mesh.py's split,
parallel/tp.py, the partial forms of the stage, block and MLP ops and
ops/residual_ln.py) against the JAX package's under `make_mesh(dp=1,
tp=2)` + `shard_params` and against the port on one process, on the CPU at
C=256, 4 heads, depth 2, F=27.

In process: the parameter spec key by key against JAX's, the split's round
trip bit for bit, the rank layout against JAX's device layout, and each
partial form's plain version summed over the ranks and finished by
`residual_ln` against the whole op (fp32 1e-5: summation order) and the
JAX Pallas kernel in interpret mode (2e-5, the ops tolerance). Then two
gloo ranks at tp=2 (started once for the module): `D3DP.sample` at fuse
levels 0-5 and with feature reuse at level 5 on injected noise (5e-4, the
DDIM replay tolerance, against JAX and one process; levels 1-5, which run
the whole kernels on the gathered weights, equal to one process bit for
bit), the replicated
parameters' gradients equal across the ranks, and a checkpoint round trip
(a one-process save loaded by the ranks and saved again: equal bit for
bit, AdamW moments included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from d3dp_tpu import parallel as jpar
from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.models import MixSTEConfig as JMixSTEConfig
from d3dp_tpu.ops.attention import _attention_block_fwd, _attention_stage_fwd
from d3dp_tpu.ops.mlp import _mlp_block_fwd, _mlp_block_t_fwd
from d3dp_tpu.train.convert_torch import torch_mixste_to_flax
from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig
from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.ops import mlp as tmlp
from d3dp_tpu_torch.ops.residual_ln import residual_ln
from d3dp_tpu_torch.parallel import mesh as tmesh
from d3dp_tpu_torch.parallel import multihost as tmulti
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from tests import torch_dp_workers as W
from tests import torch_tp_workers as TW
from tests.test_torch_model import random_params

torch.set_num_threads(1)

CFG = dict(num_frames=27, num_joints=17, embed_dim=256, depth=2, num_heads=4)
C, HEADS, HIDDEN = 256, 4, 512


# ------------------------------------------------------------- in process
def test_param_spec_matches_jax():
    """Key by key through the JAX package's name map: each torch tensor is
    filled with its index, which torch_mixste_to_flax carries to its flax
    leaf. 27 split leaves at depth 2: 6 a block and the time MLP's 3."""
    sd = MixSTE2(MixSTEConfig(**CFG), device="cpu").state_dict()
    keys = list(sd)
    tagged = {k: np.full(sd[k].shape, float(i), np.float32) for i, k in enumerate(keys)}
    flax = torch_mixste_to_flax(tagged, CFG["depth"])
    specs = jax.tree_util.tree_leaves(jpar.mixste_param_spec(flax),
                                      is_leaf=lambda x: isinstance(x, P))
    leaves = jax.tree_util.tree_leaves(flax)
    assert len(specs) == len(leaves) == len(keys)
    as_port = {P(None, "tp"): "col", P("tp"): "col", P("tp", None): "row", P(): None}
    want = {keys[int(np.asarray(leaf).flat[0])]: as_port[s] for leaf, s in zip(leaves, specs)}
    got = tmesh.mixste_param_spec(sd)
    assert got == want
    assert sum(v is not None for v in got.values()) == 27
    assert got["time_mlp.1.weight"] == "col" and got["time_mlp.3.weight"] == "row"
    assert got["STEblocks.0.attn.proj.bias"] is None and got["time_mlp.3.bias"] is None


@pytest.mark.parametrize("tp", [2, 4])
def test_split_round_trip_and_head_alignment(tp):
    """join(split(sd)) is sd bit for bit; rank j's qkv holds heads
    j h/tp .. of each of q, k and v with their bias thirds; the row-parallel
    weights their input columns; the row-parallel biases stay whole."""
    params = random_params(JMixSTEConfig(**CFG), seed=5)
    sd = state_dict_from_flax(params, CFG["depth"])
    parts = [tmesh.split_state_dict(sd, tp, j) for j in range(tp)]
    back = tmesh.join_state_dicts(parts)
    assert list(back) == list(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    cl, hl = C // tp, HIDDEN // tp
    for j, part in enumerate(parts):
        w, b = sd["STEblocks.1.attn.qkv.weight"], sd["STEblocks.1.attn.qkv.bias"]
        rows = [w[p * C + j * cl:p * C + (j + 1) * cl] for p in range(3)]
        assert torch.equal(part["STEblocks.1.attn.qkv.weight"], torch.cat(rows))
        assert torch.equal(part["STEblocks.1.attn.qkv.bias"],
                           torch.cat([b[p * C + j * cl:p * C + (j + 1) * cl] for p in range(3)]))
        assert torch.equal(part["TTEblocks.0.attn.proj.weight"],
                           sd["TTEblocks.0.attn.proj.weight"][:, j * cl:(j + 1) * cl])
        assert torch.equal(part["TTEblocks.0.mlp.fc2.weight"],
                           sd["TTEblocks.0.mlp.fc2.weight"][:, j * hl:(j + 1) * hl])
        assert torch.equal(part["time_mlp.1.bias"], sd["time_mlp.1.bias"][j * C * 2 // tp:
                                                                         (j + 1) * C * 2 // tp])
        for k in ("TTEblocks.0.attn.proj.bias", "STEblocks.0.mlp.fc2.bias", "time_mlp.3.bias",
                  "Spatial_norm.weight", "head.1.weight"):
            assert part[k] is sd[k]


@pytest.mark.parametrize("dp,tp", [(1, 2), (2, 2), (4, 2), (2, 4)])
def test_rank_layout_matches_jax_devices(dp, tp):
    """Rank r is JAX's device (r // tp, r % tp) of make_mesh(dp, tp): its
    batch rows are that device's shard, the same across a tp group."""
    mesh = jpar.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    arr = jax.device_put(x, jpar.batch_sharding(mesh))
    for r in range(dp * tp):
        m = tmesh.Mesh(dp, tp, r, (torch.device("cpu"),) * (dp * tp))
        assert (m.dp_index, m.tp_index) == (r // tp, r % tp)
        dev = mesh.devices[r // tp, r % tp]
        shard = [s for s in arr.addressable_shards if s.device == dev][0]
        np.testing.assert_array_equal(x[tmesh.batch_rows(8, m)], np.asarray(shard.data))


def _rank_slices(tp, j):
    """Rank j's qkv columns (kernel layout, head-aligned) and its C / tp and
    H / tp slices."""
    cl, hl = C // tp, HIDDEN // tp
    qkv = torch.cat([torch.arange(p * C + j * cl, p * C + (j + 1) * cl) for p in range(3)])
    return qkv, slice(j * cl, (j + 1) * cl), slice(j * hl, (j + 1) * hl)


def _t(*arrs):
    return [torch.from_numpy(np.asarray(a)) for a in arrs]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("kind", ["stage", "block", "mlp_t", "mlp_rows"])
def test_partial_forms_sum_to_the_whole(kind, tp, rng):
    """The ranks' partials summed (fp32) and finished by residual_ln: the
    whole op's plain version (1e-5) and the JAX Pallas kernel (2e-5)."""
    R, N = 3, 17
    scale, eps = (C // HEADS) ** -0.5, 1e-6
    heads = HEADS // tp

    def rn(*shape, s=1.0):
        return (rng.randn(*shape) * s).astype(np.float32)

    vec = dict(bias=rn(C, s=0.02), s=1 + rn(C, s=0.1), b=rn(C, s=0.1))
    if kind == "stage":
        x, wqkv, bqkv, wp = rn(R, N, C, s=0.5), rn(C, 3 * C, s=0.05), rn(3 * C, s=0.02), \
            rn(C, C, s=0.05)
        l1s, l1b = 1 + rn(C, s=0.1), rn(C, s=0.1)
        whole = (x, wqkv, bqkv, wp, vec["bias"], l1s, l1b, vec["s"], vec["b"])
        parts = []
        for j in range(tp):
            qi, cs, _ = _rank_slices(tp, j)
            parts.append(tattn.attention_stage_partial(
                *_t(x, wqkv[:, qi], bqkv[qi], l1s, l1b, wp[cs]), heads, scale, eps))
        got = residual_ln(*_t(x), sum(parts), *_t(vec["bias"], vec["s"], vec["b"]), eps)
        want = tattn.attention_stage_plain(*_t(*whole), HEADS, scale, eps)
        jax_want = _attention_stage_fwd(*[jnp.asarray(a) for a in whole], HEADS, scale, eps,
                                        interpret=True, tb=1)
    elif kind == "block":
        qkv, res, wp = rn(R, N, 3 * C), rn(R, N, C, s=0.5), rn(C, C, s=0.05)
        whole = (qkv, res, wp, vec["bias"], vec["s"], vec["b"])
        parts = []
        for j in range(tp):
            qi, cs, _ = _rank_slices(tp, j)
            parts.append(tattn.attention_block_partial(*_t(qkv[..., qi], wp[cs]), heads, scale))
        got = residual_ln(*_t(res), sum(parts), *_t(vec["bias"], vec["s"], vec["b"]), eps)
        want = tattn.attention_block_plain(*_t(*whole), HEADS, scale, eps)
        jax_want = _attention_block_fwd(*[jnp.asarray(a) for a in whole], HEADS, scale, eps,
                                        interpret=True)
    else:
        shape = (2, 5, 7, C) if kind == "mlp_t" else (37, C)
        x, res = rn(*shape), rn(*shape)
        w1, b1, w2 = rn(C, HIDDEN, s=0.05), rn(HIDDEN, s=0.02), rn(HIDDEN, C, s=0.05)
        whole = (x, res, w1, b1, w2, vec["bias"], vec["s"], vec["b"])
        parts = [tmlp.mlp_block_partial(*_t(x.reshape(-1, C), w1[:, hs], b1[hs], w2[hs]))
                 for hs in (_rank_slices(tp, j)[2] for j in range(tp))]
        part = sum(parts).view(shape)
        got = (residual_ln(*_t(res), part, *_t(vec["bias"], vec["s"], vec["b"]), eps,
                           with_x2=False, transpose=kind == "mlp_t"),)
        if kind == "mlp_t":
            want = (tmlp.mlp_block_t_plain(*_t(*whole), eps),)
            jax_want = (_mlp_block_t_fwd(*[jnp.asarray(a) for a in whole], eps, interpret=True,
                                         tile=128),)
        else:
            want = (tmlp.mlp_block_plain(*_t(*whole), eps),)
            jax_want = (_mlp_block_fwd(*[jnp.asarray(a) for a in whole], eps, interpret=True,
                                       tr=16),)
    for g, w, jw in zip(got, want, jax_want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), atol=2e-5, rtol=0)


def test_unported_tp_paths_raise(monkeypatch):
    """The two paths that had no tensor-parallel form (and raised here) now
    run on a split model: under the hmqkv variant level 4 evaluates with
    the whole head-major stage (K8) on the tp group's gathered weights, as
    XLA runs the JAX package's Pallas call, equal to one process bit for
    bit, and with D3DP_TRAIN_FUSED=1 training takes the partial forms'
    autograd Functions and `residual_ln_ad` (K8-tp under hmqkv), with a
    gradient for every parameter. Rank 0 of 2 without a process group
    computes its own share only (the gather stands in for the collective
    with the whole weights); the two ranks' results against JAX and one
    process are tests/test_torch_tp_fused.py's. shard_params' own errors
    still raise."""
    from d3dp_tpu_torch.models import mixste as tmixste

    model = MixSTE2(MixSTEConfig(**CFG, fuse_level=4), device="cpu")
    one = MixSTE2(MixSTEConfig(**CFG, fuse_level=4), device="cpu")
    whole = {k: v.detach().clone() for k, v in model.state_dict().items()}
    tmesh.shard_params(model, tmesh.Mesh(1, 2, 0, (torch.device("cpu"),) * 2))
    assert model.STEblocks[0].attn.num_heads == 2 and model.tp.size == 2
    calls = {}
    monkeypatch.setattr(tmixste, "gather_params",
                        lambda m: calls.update(gather=calls.get("gather", 0) + 1) or whole)
    for mod, name in ((tattn, "attention_stage_hm_partial"), (tattn, "attention_stage_partial"),
                      (tattn, "attention_stage_hm"), (tattn, "attention_stage_partial_ad"),
                      (tmlp, "mlp_block_partial_ad"), (tmixste, "residual_ln_ad")):
        def wrap(*a, _f=getattr(mod, name), _n=name, **k):
            calls[_n] = calls.get(_n, 0) + 1
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, wrap)
    rng = np.random.RandomState(2)
    x2d, x3d = (torch.from_numpy(rng.randn(1, 27, 17, n).astype(np.float32) * 0.3)
                for n in (2, 3))
    t = torch.tensor([500])
    monkeypatch.setenv("D3DP_ATTN_VARIANT", "hmqkv")
    out = model(x2d, x3d, t)
    assert out.shape == (1, 27, 17, 3) and torch.isfinite(out).all()
    assert calls == {"gather": 1, "attention_stage_hm": 4}
    calls.clear()
    assert torch.equal(out, one(x2d, x3d, t))
    monkeypatch.setenv("D3DP_TRAIN_FUSED", "1")
    for variant, want in (("hmqkv", 4), ("", 0)):
        calls.clear()
        monkeypatch.setenv("D3DP_ATTN_VARIANT", variant)
        model.zero_grad()
        model(x2d, x3d, t, train=True, drop_path=False).square().mean().backward()
        assert calls == {"attention_stage_partial_ad": 4, "attention_stage_partial": 4,
                         "mlp_block_partial_ad": 4, "residual_ln_ad": 8,
                         **({"attention_stage_hm_partial": want} if want else {})}
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in model.parameters())
    with pytest.raises(ValueError, match="already split"):
        tmesh.shard_params(model, tmesh.Mesh(1, 2, 0, (torch.device("cpu"),) * 2))
    with pytest.raises(ValueError, match="must divide"):
        tmesh.shard_params(MixSTE2(MixSTEConfig(**CFG), device="cpu"),
                           tmesh.Mesh(1, 3, 0, (torch.device("cpu"),) * 3))


# --------------------------------------------------- two ranks on the CPU
def _inputs(tmp):
    params = random_params(JMixSTEConfig(**CFG), seed=6, scale=0.02)
    rng = np.random.RandomState(8)
    B, F = 2, CFG["num_frames"]
    x2d = TW.rng_batch(9, B, F)[0]
    x2d_f = TW.rng_batch(10, B, F)[0]
    noise = (rng.randn(B, W.H, F, 17, 3).astype(np.float32),
             rng.randn(W.K, B, W.H, F, 17, 3).astype(np.float32))
    reuse = (rng.randn(B, W.H, F, 17, 3).astype(np.float32),
             rng.randn(3, B, W.H, F, 17, 3).astype(np.float32))
    gx2d, gx3d = TW.rng_batch(11, 3, F)
    masker = MixSTE2(MixSTEConfig(**CFG, drop_path_rate=0.1), device="cpu")
    inputs = dict(cfg=CFG, params=params, state_dict=state_dict_from_flax(params, 2),
                  sample_x2d=(x2d, x2d_f), sample_noise=noise, reuse_noise=reuse,
                  grad_batch=(gx2d, gx3d, rng.randint(0, 1000, (3,)).astype(np.int64),
                              rng.randn(3, F, 17, 3).astype(np.float32)),
                  grad_masks=TW.grad_masks(masker, 3, 12), ref_ckpt=str(tmp / "ref.ckpt"))
    TW.one_step_checkpoint(inputs, inputs["ref_ckpt"])
    return inputs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's], the one-process results, tmp)."""
    tmp = tmp_path_factory.mktemp("tp")
    inputs = _inputs(tmp)
    path = str(tmp / "inputs.pt")
    torch.save({k: v for k, v in inputs.items() if k != "params"}, path)
    tmulti.spawn(W.rank_main, 2, path, str(tmp), 1, 2, TW.sample_tasks)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return inputs, ranks, TW.sample_tasks(inputs), tmp


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4, 5])
def test_sample_matches_jax_and_one_process(runs, level):
    inputs, ranks, one, _ = runs
    jcfg = JMixSTEConfig(**CFG, attention_impl="pallas", fuse_level=level)
    jd = JD3DP(JD3DPConfig(model=jcfg, num_proposals=W.H, sampling_timesteps=W.K))
    mesh = jpar.make_mesh(dp=1, tp=2, devices=jax.devices()[:2])
    want = np.asarray(jd.sample({"params": jpar.shard_params(inputs["params"], mesh)},
                                jax.random.PRNGKey(0), *inputs["sample_x2d"],
                                noise_override=inputs["sample_noise"]))
    got0, got1 = ranks[0]["sample"][level], ranks[1]["sample"][level]
    np.testing.assert_array_equal(got0, got1)
    assert got0.shape == want.shape == (2, W.K, W.H, 27, 17, 3)
    np.testing.assert_allclose(got0, want, atol=5e-4, rtol=0)
    np.testing.assert_allclose(got0, one["sample"][level], atol=5e-4, rtol=0)
    if level >= 1:  # the same kernels on the gathered weights: one process's bits
        np.testing.assert_array_equal(got0, one["sample"][level])


def test_sample_with_reuse_at_level_5_matches_one_process(runs):
    """Feature reuse at level 5 runs level 4's flow, on the gathered
    weights under tp: one process's bits."""
    _, ranks, one, _ = runs
    got = ranks[0]["sample"]["5 reuse"]
    assert got.shape == (2, 3, W.H, 27, 17, 3)
    np.testing.assert_array_equal(got, ranks[1]["sample"]["5 reuse"])
    np.testing.assert_allclose(got, one["sample"]["5 reuse"], atol=5e-4, rtol=0)
    np.testing.assert_array_equal(got, one["sample"]["5 reuse"])


def test_replicated_gradients_equal_across_the_tp_group(runs):
    """One fp32 training forward and backward (DropPath on): the loss and
    every replicated parameter's gradient equal bit for bit on both ranks
    (the sums they come from are all-reduced), within 1e-5 relative of one
    process's."""
    _, ranks, one, _ = runs
    g0, g1 = ranks[0]["grads"], ranks[1]["grads"]
    assert g0["loss"] == g1["loss"]
    assert abs(g0["loss"] - one["grads"]["loss"]) <= 1e-5 * abs(one["grads"]["loss"])
    assert len(g0["split"]) == 27 and g0["split"] == g1["split"]
    assert set(g0["grads"]) == set(g1["grads"]) and len(g0["grads"]) > 20
    for name, g in g0["grads"].items():
        np.testing.assert_array_equal(g, g1["grads"][name], err_msg=name)
        want = one["grads"]["grads"][name]
        assert np.abs(g - want).max() <= 1e-5 * np.abs(want).max() + 1e-9, name


def test_checkpoint_round_trip_is_bit_exact(runs):
    """A one-process checkpoint (weights and AdamW moments after a step)
    loaded by the tp=2 ranks (`shard_checkpoint`) and saved again (gathered
    over the group, rank 0 writing) equals the original bit for bit: a
    checkpoint is free of the (dp, tp) layout."""
    _, ranks, _, tmp = runs
    assert ranks[0]["checkpoint"] and ranks[1]["checkpoint"]
    ref = torch.load(tmp / "ref.ckpt", weights_only=False)
    got = torch.load(tmp / "dp1tp2.ckpt", weights_only=False)
    assert list(got["model_pos"]) == list(ref["model_pos"])
    for k, v in ref["model_pos"].items():
        assert torch.equal(got["model_pos"][k], v), k
    assert got["optimizer"]["param_groups"] == ref["optimizer"]["param_groups"]
    assert set(got["optimizer"]["state"]) == set(ref["optimizer"]["state"])
    for i, st in ref["optimizer"]["state"].items():
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(got["optimizer"]["state"][i][k], st[k]), (i, k)

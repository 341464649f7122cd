"""The last tensor-parallel paths of the port, `D3DP_ATTN_VARIANT=hmqkv` and
`D3DP_TRAIN_FUSED=1` under `--tp`, against the JAX package and against the
port on one process, on the CPU.

In process, with each rank's share computed in turn (fp32): the head-major
partial stage (K8-tp) on the rank's head-major stacks, which equal the
whole model's stacks sliced to the rank's heads; the ranks' partials summed
and finished by `residual_ln` against `attention_stage_hm_plain` (1e-5)
and JAX's head-major stage kernel in interpret mode (2e-5, the ops
tolerance); `residual_ln` with a DropPath scale in its three layouts
(attention rows, MLP rows, MLP transposed) against its plain twin bit for
bit, and, after the ranks' partials, against the port's DropPath ops
(1e-5) and JAX's (2e-5); the partial forms' autograd Functions summed over
the ranks against the whole ops' Functions (gradients 2e-5) and JAX's
custom VJPs (2e-4, tests/test_torch_droppath_fused.py's bound).

Two gloo ranks at tp=2 (started once for the module,
`torch_tp_workers.fused_tasks`): `sample` at level 4 under hmqkv against
JAX under `make_mesh(dp=1, tp=2)` + `shard_params` and one process (5e-4,
tests/test_torch_tp.py's bound); the loss and every gradient of a
`D3DP_TRAIN_FUSED=1` forward at fuse levels 1, 2 and 4 with DropPath
against one process (loss 1e-5 relative, gradients 2e-5) and JAX's
`value_and_grad` under the same switch and mesh (loss 2e-5 relative,
gradients 2e-5);
the replicated gradients and, after 3 steps, the replicated parameters
equal bit for bit on both ranks; and `--ckpt-format orbax` (DCP)
checkpoints across tp 1 and 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3dp_tpu import parallel as jpar
from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.models import MixSTEConfig as JMixSTEConfig
from d3dp_tpu.ops import attention as jattn
from d3dp_tpu.ops import mlp as jmlp
from d3dp_tpu.ops.attention import _attention_stage_fwd
from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.ops import mlp as tmlp
from d3dp_tpu_torch.ops.residual_ln import residual_ln, residual_ln_ad, residual_ln_plain
from d3dp_tpu_torch.parallel import multihost as tmulti
from d3dp_tpu_torch.train import checkpoint_io
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from tests import torch_dp_workers as W
from tests import torch_tp_workers as TW
from tests.test_torch_kernels import _mlp_inputs, _stage_inputs
from tests.test_torch_model import SMALL, random_params
from tests.test_torch_tp import CFG, _inputs as tp_inputs
from tests.test_torch_train import WEIGHTS, _batch, _droppath_masks, _jax_loss_and_grads

torch.set_num_threads(1)

C, HEADS, HIDDEN = 256, 4, 512
SCALE, EPS = (C // HEADS) ** -0.5, 1e-6
FUSED_CFG = dict(SMALL, drop_path_rate=0.1)
SWITCHES = ("D3DP_ATTN_VARIANT", "D3DP_ATTN_VARIANT_T", "D3DP_ATTN_VARIANT_S",
            "D3DP_SPATIAL_GROUP", "D3DP_SOFTMAX_FOLD", "D3DP_MLP_VARIANT", "D3DP_TRAIN_FUSED")


@pytest.fixture
def env(monkeypatch):
    """monkeypatch with every lab switch unset and JAX's caches dropped
    around the test (JAX reads the switches when it traces)."""
    for k in SWITCHES:
        monkeypatch.delenv(k, raising=False)
    jax.clear_caches()
    yield monkeypatch
    monkeypatch.undo()
    jax.clear_caches()


def _qkv_index(tp, j, width=C):
    """Rank j's columns of a packed (., 3 width) qkv: its heads' share of
    each of q, k and v (`shard_params`' split)."""
    cl = width // tp
    return np.concatenate([np.arange(p * width + j * cl, p * width + (j + 1) * cl)
                           for p in range(3)])


def _t(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrs]


def _dp(rng, shape, keep=0.9):
    """DropPath scales with at least one dropped and one kept entry."""
    m = np.where(rng.rand(*shape) < keep, 1.0 / keep, 0.0).astype(np.float32)
    m.flat[0], m.flat[-1] = 0.0, 1.0 / keep
    return m


# ------------------------------------------------------------- in process
@pytest.mark.parametrize("tp", [2, 4])
def test_hm_partial_stacks_are_the_whole_stack_sliced(rng, tp):
    """stack_head_major of a rank's (C, 3 C_l) qkv equals the whole
    model's head-major stack sliced to the rank's heads, bit for bit."""
    wqkv, bqkv = rng.randn(C, 3 * C).astype(np.float32), rng.randn(3 * C).astype(np.float32)
    whole_w, whole_b = tattn.stack_head_major(*_t(wqkv, bqkv), HEADS)
    hl = HEADS // tp
    for j in range(tp):
        qi = _qkv_index(tp, j)
        w, b = tattn.stack_head_major(*_t(wqkv[:, qi], bqkv[qi]), hl)
        assert torch.equal(w, whole_w[j * hl:(j + 1) * hl])
        assert torch.equal(b, whole_b[j * hl:(j + 1) * hl])


@pytest.mark.parametrize("tp", [2, 4])
def test_hm_partial_forms_sum_to_the_whole(env, rng, tp):
    """K8-tp's plain twin on each rank, summed and finished by
    residual_ln: `attention_stage_hm_plain` within 1e-5 and JAX's stage
    under hmqkv within 2e-5; `attention_stage_partial` routes there under
    the switch, bit for bit."""
    env.setenv("D3DP_ATTN_VARIANT", "hmqkv")
    R, N = 3, 17
    x, wqkv, bqkv, wp, bp, l1s, l1b, l2s, l2b = _stage_inputs(rng, R, N, C, w_scale=0.05)
    hl, cl = HEADS // tp, C // tp
    parts = []
    for j in range(tp):
        qi = _qkv_index(tp, j)
        rank = _t(x, wqkv[:, qi], bqkv[qi], l1s, l1b, wp[j * cl:(j + 1) * cl])
        w_hm, b_hm = tattn.stack_head_major(rank[1], rank[2], hl)
        parts.append(tattn.attention_stage_hm_partial_plain(
            rank[0], w_hm, b_hm, *rank[3:], hl, SCALE, EPS))
        assert torch.equal(parts[-1], tattn.attention_stage_partial(*rank, hl, SCALE, EPS))
    got = residual_ln(*_t(x), sum(parts), *_t(bp, l2s, l2b), EPS)
    whole = _t(x, wqkv, bqkv, wp, bp, l1s, l1b, l2s, l2b)
    w_hm, b_hm = tattn.stack_head_major(whole[1], whole[2], HEADS)
    want = tattn.attention_stage_hm_plain(whole[0], w_hm, b_hm, *whole[3:], HEADS, SCALE, EPS)
    jax_want = _attention_stage_fwd(*[jnp.asarray(a) for a in (x, wqkv, bqkv, wp, bp, l1s, l1b,
                                                               l2s, l2b)],
                                    HEADS, SCALE, EPS, interpret=True)
    for g, w, jw in zip(got, want, jax_want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), atol=2e-5, rtol=0)


@pytest.mark.parametrize("layout", ["attention", "mlp_rows", "mlp_t"])
def test_residual_ln_dp_matches_the_droppath_ops(rng, layout):
    """residual_ln with a DropPath scale: its plain twin bit for bit (the
    wrapper on a CPU tensor), unit scales the op without one bit for bit,
    and after two ranks' partial products the port's DropPath op (1e-5)
    and JAX's (2e-5): attention_stage_dp (dp (R,) over rows of N tokens),
    mlp_block_dp (rows (B, D1, D2), dp (B, D1)) and mlp_block_t_dp."""
    tp = 2
    if layout == "attention":
        R, N = 3, 17
        x, wqkv, bqkv, wp, bp, l1s, l1b, l2s, l2b = _stage_inputs(rng, R, N, C, w_scale=0.05)
        dp = _dp(rng, (R,))
        cl = C // tp
        parts = [tattn.attention_stage_partial_plain(
            *_t(x, wqkv[:, _qkv_index(tp, j)], bqkv[_qkv_index(tp, j)], l1s, l1b,
                wp[j * cl:(j + 1) * cl]), HEADS // tp, SCALE, EPS) for j in range(tp)]
        res, bias, ln, kw = _t(x)[0], _t(bp)[0], _t(l2s, l2b), {}
        args = _t(x, wqkv, bqkv, wp, bp, l1s, l1b, l2s, l2b)
        want = tattn.attention_stage_dp_plain(*args, _t(dp)[0], HEADS, SCALE, EPS)
        jax_want = jattn.attention_stage_dp_p(
            *[jnp.asarray(a) for a in (x, wqkv, bqkv, wp, bp, l1s, l1b, l2s, l2b, dp)],
            HEADS, SCALE, EPS)
    else:
        B, D1, D2 = 2, 5, 7
        a = _mlp_inputs(rng, B, D1, D2, C, HIDDEN)
        dp = _dp(rng, (B, D1))
        hl = HIDDEN // tp
        parts = [tmlp.mlp_block_partial_plain(
            *_t(a[0].reshape(-1, C), a[2][:, j * hl:(j + 1) * hl], a[3][j * hl:(j + 1) * hl],
                a[4][j * hl:(j + 1) * hl])).view(B, D1, D2, C) for j in range(tp)]
        res, bias, ln = _t(a[1])[0], _t(a[5])[0], _t(a[6], a[7])
        kw = dict(with_x2=False, transpose=layout == "mlp_t")
        if layout == "mlp_t":
            want = (tmlp.mlp_block_t_dp_plain(*_t(*a), _t(dp)[0], EPS),)
            jax_want = (jmlp.mlp_block_t_dp_p(*[jnp.asarray(v) for v in a], jnp.asarray(dp),
                                              EPS),)
        else:
            rows = [v.reshape(-1, C) for v in a[:2]] + a[2:]
            want = (tmlp.mlp_block_dp_plain(*_t(*rows), _t(dp.reshape(-1).repeat(D2))[0],
                                            EPS).view(B, D1, D2, C),)
            jax_want = (jmlp.mlp_block_dp_p(*[jnp.asarray(v) for v in rows],
                                            jnp.asarray(dp.reshape(-1).repeat(D2)),
                                            EPS).reshape(B, D1, D2, C),)
    part, dpt = sum(parts), _t(dp)[0]
    got = residual_ln(res, part, bias, *ln, EPS, dp=dpt, **kw)
    twin = residual_ln_plain(res, part, bias, *ln, EPS, dp=dpt, **kw)
    got, twin = (got, twin) if isinstance(got, tuple) else ((got,), (twin,))
    for g, tw, w, jw in zip(got, twin, want, jax_want):
        assert torch.equal(g, tw)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), atol=2e-5, rtol=0)
    ones = torch.ones_like(dpt)
    for g, w in zip(*[(o if isinstance(o, tuple) else (o,)) for o in (
            residual_ln(res, part, bias, *ln, EPS, dp=ones, **kw),
            residual_ln(res, part, bias, *ln, EPS, **kw))]):
        assert torch.equal(g, w)
    with pytest.raises(ValueError, match="leading part"):
        residual_ln(res, part, bias, *ln, EPS, dp=dpt.reshape(-1)[:1], **kw)


def _leaves(*arrs):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(True) for a in arrs]


def _grads(outs, leaves, cts):
    outs = outs if isinstance(outs, tuple) else (outs,)
    return [o.detach() for o in outs], torch.autograd.grad(outs, leaves,
                                                           [torch.from_numpy(c) for c in cts])


@pytest.mark.parametrize("kind", ["stage", "stage_hm", "block", "mlp_t"])
def test_partial_ad_sums_to_the_whole_ad(env, rng, kind):
    """Each partial form's autograd Function on both ranks, the partials
    summed and finished by residual_ln_ad (with DropPath for the stage and
    the transposed MLP): outputs and every gradient, the split ones joined,
    against the whole op's Function (2e-5) and JAX's custom VJP (2e-4)."""
    tp, C_, H_ = 2, 64, 128
    heads = 4
    cl, hl = C_ // tp, H_ // tp
    if kind == "stage_hm":
        env.setenv("D3DP_ATTN_VARIANT", "hmqkv")
    if kind.startswith("stage"):
        R, N = 3, 17
        arrs = _stage_inputs(rng, R, N, C_)
        dp = _dp(rng, (R,))
        cts = [rng.randn(R, N, C_).astype(np.float32) for _ in range(2)]
        whole = _leaves(*arrs)
        want = _grads(tattn.attention_stage_dp_ad(*whole, torch.from_numpy(dp), heads, 0.125,
                                                  EPS), whole, cts)
        jouts, jvjp = jax.vjp(lambda *a: jattn.attention_stage_dp_p(*a, jnp.asarray(dp), heads,
                                                                    0.125, EPS),
                              *[jnp.asarray(a) for a in arrs])
        lv = _leaves(*arrs)
        x, wqkv, bqkv, wp, bp, l1s, l1b, l2s, l2b = lv
        parts = [tattn.attention_stage_partial_ad(
            x, wqkv[:, _qkv_index(tp, j, C_)], bqkv[_qkv_index(tp, j, C_)], l1s, l1b,
            wp[j * cl:(j + 1) * cl], heads // tp, 0.125, EPS) for j in range(tp)]
        got = _grads(residual_ln_ad(x, sum(parts), bp, l2s, l2b, EPS, dp=torch.from_numpy(dp)),
                     lv, cts)
    elif kind == "block":
        R, N = 3, 17
        arrs = [rng.randn(R, N, 3 * C_).astype(np.float32),
                rng.randn(R, N, C_).astype(np.float32),
                (rng.randn(C_, C_) * 0.1).astype(np.float32),
                (rng.randn(C_) * 0.05).astype(np.float32),
                (1 + 0.1 * rng.randn(C_)).astype(np.float32),
                (0.1 * rng.randn(C_)).astype(np.float32)]
        cts = [rng.randn(R, N, C_).astype(np.float32) for _ in range(2)]
        whole = _leaves(*arrs)
        want = _grads(tattn.attention_block_ad(*whole, heads, 0.125, EPS), whole, cts)
        jouts, jvjp = jax.vjp(lambda *a: jattn.attention_block_p(*a, heads, 0.125, EPS),
                              *[jnp.asarray(a) for a in arrs])
        lv = _leaves(*arrs)
        qkv, res, w, b, ls, lb = lv
        parts = [tattn.attention_block_partial_ad(qkv[..., _qkv_index(tp, j, C_)],
                                                  w[j * cl:(j + 1) * cl], heads // tp, 0.125)
                 for j in range(tp)]
        got = _grads(residual_ln_ad(res, sum(parts), b, ls, lb, EPS), lv, cts)
    else:
        B, D1, D2 = 2, 5, 7
        arrs = _mlp_inputs(rng, B, D1, D2, C_, H_)
        dp = _dp(rng, (B, D1))
        cts = [rng.randn(B, D2, D1, C_).astype(np.float32)]
        whole = _leaves(*arrs)
        want = _grads(tmlp.mlp_block_t_dp_ad(*whole, torch.from_numpy(dp), EPS), whole, cts)
        jouts, jvjp = jax.vjp(lambda *a: jmlp.mlp_block_t_dp_p(*a, jnp.asarray(dp), EPS),
                              *[jnp.asarray(a) for a in arrs])
        lv = _leaves(*arrs)
        x, res, w1, b1, w2, b2, ls, lb = lv
        parts = [tmlp.mlp_block_partial_ad(x.reshape(-1, C_), w1[:, j * hl:(j + 1) * hl],
                                           b1[j * hl:(j + 1) * hl], w2[j * hl:(j + 1) * hl])
                 for j in range(tp)]
        got = _grads(residual_ln_ad(res, sum(parts).view(B, D1, D2, C_), b2, ls, lb, EPS,
                                    with_x2=False, transpose=True, dp=torch.from_numpy(dp)),
                     lv, cts)
    jouts = jouts if isinstance(jouts, tuple) else (jouts,)
    jgrads = jvjp(tuple(jnp.asarray(c) for c in cts) if len(cts) > 1 else jnp.asarray(cts[0]))
    for g, w, jw in zip(got[0], want[0], jouts):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), atol=2e-5, rtol=0)
    for i, (g, w, jw) in enumerate(zip(got[1], want[1], jgrads)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5, rtol=0, err_msg=str(i))
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), atol=2e-4, rtol=0, err_msg=str(i))


# --------------------------------------------------- two ranks on the CPU
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, [rank 0's fused_tasks, rank 1's], the one-process results,
    tmp): the one-process run first, whose DCP checkpoint the ranks load."""
    tmp = tmp_path_factory.mktemp("tp_fused")
    inputs = tp_inputs(tmp)
    fused_params = random_params(JMixSTEConfig(**SMALL), seed=3)
    x2d, x3d, t, noise = _batch(4)
    inputs.update(fused_cfg=SMALL, fused_params=fused_params,
                  fused_state_dict=state_dict_from_flax(fused_params, SMALL["depth"]),
                  fused_batch=(x2d, x3d, t.astype(np.int64), noise, WEIGHTS),
                  fused_masks=_droppath_masks(FUSED_CFG, 5), tmp=str(tmp))
    one = TW.fused_tasks(inputs)
    path = str(tmp / "inputs.pt")
    torch.save({k: v for k, v in inputs.items() if k not in ("params", "fused_params")}, path)
    tmulti.spawn(W.rank_main, 2, path, str(tmp), 1, 2, TW.fused_tasks)
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return inputs, ranks, one, tmp


def jax_mesh():
    return jpar.make_mesh(dp=1, tp=2, devices=jax.devices()[:2])


def test_hmqkv_sample_matches_jax_and_one_process(runs, env):
    """Level 4 under hmqkv (K8-tp on each rank): equal on both ranks, within
    5e-4 of JAX's head-major stage under the tp mesh and of one process."""
    inputs, ranks, one, _ = runs
    env.setenv("D3DP_ATTN_VARIANT", "hmqkv")
    jcfg = JMixSTEConfig(**CFG, attention_impl="pallas", fuse_level=4)
    jd = JD3DP(JD3DPConfig(model=jcfg, num_proposals=W.H, sampling_timesteps=W.K))
    want = np.asarray(jd.sample({"params": jpar.shard_params(inputs["params"], jax_mesh())},
                                jax.random.PRNGKey(0), *inputs["sample_x2d"],
                                noise_override=inputs["sample_noise"]))
    got = ranks[0]["hm_sample"]
    np.testing.assert_array_equal(got, ranks[1]["hm_sample"])
    assert got.shape == want.shape == (2, W.K, W.H, 27, 17, 3)
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    np.testing.assert_allclose(got, one["hm_sample"], atol=5e-4, rtol=0)


@pytest.mark.parametrize("level", TW.FUSED_LEVELS)
def test_train_fused_loss_and_grads_match_jax_and_one_process(runs, env, level):
    """fp32, DropPath 0.1 with injected masks, D3DP_TRAIN_FUSED=1 at
    `level`: the tp=2 loss and every gradient (split ones gathered) against
    one process (loss 1e-5 relative, gradients 2e-5) and JAX's
    value_and_grad on params sharded over make_mesh(dp=1, tp=2) under the
    same switch (loss 2e-5 relative, gradients 2e-5; 3.6e-7 read)."""
    inputs, ranks, one, _ = runs
    env.setenv("D3DP_TRAIN_FUSED", "1")
    cfg = dict(FUSED_CFG, fuse_level=level)
    x2d, x3d, t, noise, _ = inputs["fused_batch"]
    jloss, jgrads = _jax_loss_and_grads(jpar.shard_params(inputs["fused_params"], jax_mesh()),
                                        cfg, "pallas", (x2d, x3d, t, noise),
                                        inputs["fused_masks"], env)
    want = state_dict_from_flax(jgrads, SMALL["depth"])
    got, ref = ranks[0]["fused_grads"][level], one["fused_grads"][level]
    assert got["loss"] == ranks[1]["fused_grads"][level]["loss"]
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert abs(got["loss"] - jloss) <= 2e-5 * abs(jloss)
    assert set(got["grads"]) == set(want) == set(ref["grads"])
    for name, g in got["grads"].items():
        np.testing.assert_allclose(g, ref["grads"][name], atol=2e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(g, want[name].numpy(), atol=2e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("level", TW.FUSED_LEVELS)
def test_train_fused_replicated_gradients_equal_across_the_tp_group(runs, level):
    """The replicated parameters' gradients (LN, the row-parallel biases,
    the norms, the embeddings) on the two ranks of the tp group equal bit
    for bit: each is either all-reduced or computed from all-reduced sums,
    never summed twice."""
    _, ranks, one, _ = runs
    g0, g1 = ranks[0]["fused_grads"][level], ranks[1]["fused_grads"][level]
    assert set(g0["replicated"]) == set(g1["replicated"]) and len(g0["replicated"]) > 20
    for name, g in g0["replicated"].items():
        np.testing.assert_array_equal(g, g1["replicated"][name], err_msg=name)
        np.testing.assert_allclose(g, one["fused_grads"][level]["grads"][name], atol=2e-5,
                                   rtol=0, err_msg=name)


def test_train_fused_steps_keep_the_replicas_equal(runs):
    """3 `D3DP_TRAIN_FUSED=1` AdamW steps at level 4 with DropPath drawn by
    the step: equal losses and replicated parameters on both ranks, bit for
    bit; losses within 1e-5 relative and parameters within 1e-3 relative L2
    of one process (AdamW normalizes each step's rounding to a full step,
    tests/test_torch_tp_ranks.py's bound)."""
    _, ranks, one, _ = runs
    s0, s1, ref = ranks[0]["fused_steps"], ranks[1]["fused_steps"], one["fused_steps"]
    assert s0["losses"] == s1["losses"] and len(s0["losses"]) == TW.FUSED_STEPS
    for a, b in zip(s0["losses"], ref["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b)
    for name, p in s0["replicated"].items():
        np.testing.assert_array_equal(p, s1["replicated"][name], err_msg=name)
    for name, p in s0["params"].items():
        want = ref["params"][name]
        assert np.linalg.norm(p - want) <= 1e-3 * np.linalg.norm(want) + 1e-9, name


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.random.RandomState):
        return all(np.array_equal(x, y) for x, y in zip(a.get_state(), b.get_state()))
    return a == b


def test_dcp_checkpoints_move_between_tp_1_and_2(runs):
    """`--ckpt-format orbax` is free of the tp layout: the tp=2 ranks' DCP
    directory holds their gathered weights (whole) and loads at tp=1; the
    one-process DCP directory, loaded by the tp=2 ranks (`shard_checkpoint`)
    and saved again as a pickle, equals it bit for bit, AdamW moments, the
    generator's RandomState, epoch, lr and min_loss included."""
    _, ranks, _, tmp = runs
    assert ranks[0]["dcp"] and ranks[1]["dcp"]
    tp2 = checkpoint_io.load_any(str(tmp / "dcp_tp2.orbax"))
    for name, p in ranks[0]["fused_steps"]["params"].items():
        assert np.array_equal(tp2["model"][name].numpy(), p), name
    assert tp2["epoch"] == 3 and tp2["min_loss"] == 12.5
    ref = checkpoint_io.load_any(str(tmp / "dcp_tp1.orbax"))
    back = checkpoint_io.load_any(str(tmp / "dcp_tp1_at_tp2.ckpt"))
    assert set(ref) == set(back)
    for k in ref:
        assert _same(back[k], ref[k]), k
    assert len(ref["optimizer"]["state"]) == len(ref["model"])

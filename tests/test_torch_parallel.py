"""The port's data-parallel layer (d3dp_tpu_torch/parallel) against the JAX
package's (d3dp_tpu/parallel), on the CPU.

The mesh functions against JAX's on the same numpy inputs; then two ranks
of the port (gloo processes, started once for the module) against the
port on one device and against the JAX package under `make_mesh(dp=2)` on
two of conftest.py's virtual CPU devices, at embed 64, depth 2, F=27:
two train steps (loss 1e-5 and parameters 1e-3 relative against one
device; loss and parameters at the training tolerance 2e-4 against JAX),
the Evaluator's four modes with host and device P2, light validation and
the prediction return (3.1e-4 mm, the whole-pipeline tolerance), the 3DHP
evaluator (errors 1e-3 mm as tests/test_torch_3dhp.py holds its log, the
exports 0.05 mm) and `sample_windows` (5e-4). The batches and micro-batches
leave one rank a weight-0 pad row, and another nothing but pad rows.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3dp_tpu.data import mpi3dhp as jdata
from d3dp_tpu.data import synthetic as jsyn
from d3dp_tpu.data import windowing as jwin
from d3dp_tpu.data.generators import UnchunkedGenerator as JGen
from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.eval import Evaluator as JEvaluator
from d3dp_tpu.eval.evaluator_3dhp import Evaluator3DHP as JEvaluator3DHP
from d3dp_tpu.models import MixSTEConfig as JMixSTEConfig
from d3dp_tpu.models.mixste import Block as JBlock
from d3dp_tpu import parallel as jpar
from d3dp_tpu.parallel import multihost as jmulti
from d3dp_tpu.train import state as jstate
from d3dp_tpu_torch import parallel as tpar
from d3dp_tpu_torch.eval import MODES
from d3dp_tpu_torch.eval.evaluator_3dhp import MODES as MODES_3DHP
from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig
from d3dp_tpu_torch.parallel import multihost as tmulti
from d3dp_tpu_torch.parallel.mesh import Mesh, mesh_size
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from tests import torch_dp_workers as W
from tests.test_torch_model import random_params
from tests.test_torch_wild import JaxKeyNoise, _key_noise

torch.set_num_threads(1)

F, H, K = W.F, W.H, W.K
LR = dict(kps_left=list(jsyn.JOINTS_LEFT), kps_right=list(jsyn.JOINTS_RIGHT))
GEN_LR = dict(LR, joints_left=list(jsyn.JOINTS_LEFT), joints_right=list(jsyn.JOINTS_RIGHT))
SYM = dict(joints_left=tuple(jsyn.JOINTS_LEFT), joints_right=tuple(jsyn.JOINTS_RIGHT))
SYM_3DHP = dict(joints_left=tuple(jdata.KPS_LEFT), joints_right=tuple(jdata.KPS_RIGHT))


def cpu_mesh(dp, rank):
    """A port mesh value for the functions that only read its shape."""
    return Mesh(dp, 1, rank, (torch.device("cpu"),) * dp)


def jax_mesh(dp):
    return jpar.make_mesh(dp=dp, devices=jax.devices()[:dp])


# ------------------------------------------------------------ mesh functions
@pytest.mark.parametrize("dp,tp,n", [(0, 1, 1), (0, 1, 8), (2, 1, 8), (1, 1, 8), (8, 1, 8),
                                     (3, 1, 2), (0, 2, 1), (0, 4, 8), (4, 4, 8)])
def test_auto_mesh_resolves_as_jax(dp, tp, n):
    """The device count --dp/--tp resolve to over n devices, None at one
    device, and JAX's errors word for word."""
    try:
        want = jpar.auto_mesh(dp, tp, devices=jax.devices()[:n])
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_size(dp, tp, n)
        assert str(got.value) == str(e)
        return
    got = mesh_size(dp, tp, n)
    assert got == (1 if want is None else want.devices.size)
    if want is None:
        assert tpar.auto_mesh(dp, tp, ["cpu"] * n) is None


@pytest.mark.parametrize("dp", [2, 4, 8])
@pytest.mark.parametrize("bs", [1, 2, 3, 4, 5, 9, 16])
def test_round_up_batch_matches_jax(bs, dp):
    assert tpar.round_up_batch(bs, cpu_mesh(dp, 0)) == jpar.round_up_batch(bs, jax_mesh(dp))
    assert tpar.round_up_batch(bs, None) == jpar.round_up_batch(bs, None) == bs


@pytest.mark.parametrize("n,world", [(8, 1), (8, 2), (9, 2), (12, 4), (4, 4)])
def test_host_slice_matches_jax(n, world, monkeypatch):
    """Each process's share, JAX's process count and index against the
    process group's world size and rank."""
    for rank in range(world):
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(jax, "process_index", lambda: rank)
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: world)
        monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: rank)
        assert tmulti.host_slice(n) == jmulti.host_slice(n)


@pytest.mark.parametrize("rows,dp", [(4, 2), (3, 2), (1, 2), (5, 4), (8, 8)])
def test_shard_batch_fn_rows_match_jax(rows, dp, rng):
    """Each rank's padded rows are its shard of JAX's padded global batch;
    the weights stay host numpy, global and padded with zeros."""
    x3d = rng.randn(rows, F, 17, 3).astype(np.float32)
    x2d = rng.randn(rows, F, 17, 2).astype(np.float32)
    w = np.ones(rows, np.float32)
    mesh = jax_mesh(dp)
    _, j3, j2, jw = jpar.shard_batch_fn(mesh)((None, x3d, x2d, w))
    for rank in range(dp):
        _, t3, t2, tw = tpar.shard_batch_fn(cpu_mesh(dp, rank))((None, x3d, x2d, w))
        assert isinstance(tw, np.ndarray) and np.array_equal(tw, jw)
        for got, want in ((t3, j3), (t2, j2)):
            shard = [s for s in want.addressable_shards if s.device == mesh.devices[rank, 0]][0]
            assert torch.equal(got, torch.from_numpy(np.asarray(shard.data)))


@pytest.mark.parametrize("dp", [2, 4])
def test_batch_and_step_noise_rows_match_jax_shardings(dp, rng):
    """batch_rows / step_noise_rows select the rows JAX's batch_sharding /
    step_noise_sharding put on each device."""
    mesh = jax_mesh(dp)
    x = rng.randn(3, 8, 5).astype(np.float32)  # (K, batch, ...)
    batch = jax.device_put(x[0], jpar.batch_sharding(mesh))
    steps = jax.device_put(x, jpar.step_noise_sharding(mesh))
    for rank in range(dp):
        dev = mesh.devices[rank, 0]
        b = [s for s in batch.addressable_shards if s.device == dev][0]
        st = [s for s in steps.addressable_shards if s.device == dev][0]
        np.testing.assert_array_equal(x[0][tpar.batch_rows(8, cpu_mesh(dp, rank))],
                                      np.asarray(b.data))
        np.testing.assert_array_equal(tpar.step_noise_rows(x, cpu_mesh(dp, rank)),
                                      np.asarray(st.data))


def test_mesh_needs_a_process_group_and_enough_devices():
    with pytest.raises(RuntimeError, match="process group"):
        tpar.make_mesh(dp=2, devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="exceeds"):
        tpar.auto_mesh(2, 1, ["cpu"])


# --------------------------------------------------- two ranks on the CPU
def _inputs(tmp):
    rng = np.random.RandomState(3)
    params = random_params(JMixSTEConfig(**W.CFG), seed=4, scale=0.02)
    batches = []
    for w in ([1, 1, 1], [1, 1, 0]):  # padded to 4: rank 1 holds a pad row / only pad rows
        batches.append((
            (rng.randn(3, F, 17, 2) * 0.3).astype(np.float32),
            (rng.randn(3, F, 17, 3) * 0.3).astype(np.float32),
            np.asarray(w, np.float32),
            rng.randint(0, 1000, (4,)).astype(np.int64),
            rng.randn(4, F, 17, 3).astype(np.float32)))
    _, _, p3, p2, valid = jdata.make_synthetic(seed=2, frames=70)
    key = jax.random.PRNGKey(5)
    window_noise = []
    cfg = JD3DPConfig(model=JMixSTEConfig(**W.CFG), num_proposals=H, sampling_timesteps=K)
    for _ in range(2):  # 7 windows at bs 3, rounded up to 4 under dp=2: 2 calls
        key, sub = jax.random.split(key)
        window_noise.append(tuple(np.asarray(a) for a in _key_noise(sub, 4, F, cfg)))
    return dict(
        params=params, state_dict=state_dict_from_flax(params, W.CFG["depth"]),
        train_batches=batches, train_seed=7,
        eval_data=jsyn.make_dataset(seed=1, lengths=(100, 80, 40)),  # 4, 3, 2 windows
        kps_left=LR["kps_left"], kps_right=LR["kps_right"], **SYM,
        data_3dhp=(p3, p2, valid), kps_3dhp=(tuple(jdata.KPS_LEFT), tuple(jdata.KPS_RIGHT)),
        windows=((rng.randn(7, F, 17, 2) * 0.3).astype(np.float32),
                 (rng.randn(7, F, 17, 2) * 0.3).astype(np.float32), 3),
        window_noise=window_noise, window_key=jax.random.PRNGKey(5),
        ckpt_path=str(tmp / "dp1.ckpt"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, [rank 0's results, rank 1's], the one-device results)."""
    tmp = tmp_path_factory.mktemp("dp")
    inputs = _inputs(tmp)
    path = str(tmp / "inputs.pt")
    torch.save({k: v for k, v in inputs.items() if k not in ("params", "window_key")}, path)
    tmulti.spawn(W.rank_main, 2, path, str(tmp))
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return inputs, ranks, W.run_tasks(inputs), tmp


def _jax_train(inputs, monkeypatch):
    """JAX's make_train_step under make_mesh(dp=2): each step's t and noise
    through t_noise_override and the port's DropPath masks through
    Block._droppath_masks, retraced per step; -> (losses, params)."""
    mesh = jax_mesh(2)
    jd = JD3DP(JD3DPConfig(model=JMixSTEConfig(**W.CFG, drop_path_rate=0.1)))
    tx = jstate.make_optimizer(W.LR_TRAIN, weight_decay=0.1)
    state = jstate.TrainState.create(
        jpar.shard_model_params({"params": inputs["params"]}, mesh), tx, mesh=mesh)
    g = torch.Generator().manual_seed(inputs["train_seed"])
    masker = MixSTE2(MixSTEConfig(**W.CFG, drop_path_rate=0.1), device="cpu")
    losses, params = [], []
    for x2d, x3d, w, t, noise in inputs["train_batches"]:
        masks = {k: tuple(m.numpy() for m in v)
                 for k, v in masker.draw_droppath_masks(4, g).items()}
        monkeypatch.setattr(JBlock, "_droppath_masks",
                            lambda self, n, masks=masks: tuple(jnp.asarray(m)
                                                               for m in masks[self.name]))
        monkeypatch.setattr(jd, "train_forward", functools.partial(
            JD3DP.train_forward, jd, t_noise_override=(t, noise)))
        _, b3, b2, bw = jpar.shard_batch_fn(mesh)((None, x3d, x2d, w))
        state, loss = jstate.make_train_step(jd, tx, donate=False)(
            state, jax.random.PRNGKey(0), b2, b3, jnp.asarray(bw))
        losses.append(float(loss))
        params.append(state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                                  state.params["params"]), 2))
    return np.asarray(losses), params


def test_train_steps_match_one_device_and_jax(runs, monkeypatch):
    inputs, ranks, one, _ = runs
    r0, r1 = ranks[0]["train"], ranks[1]["train"]
    np.testing.assert_array_equal(r0["losses"], r1["losses"])
    np.testing.assert_allclose(r0["losses"], one["train"]["losses"], rtol=1e-5, atol=0)
    for step in range(2):
        for name, want in one["train"]["params"][step].items():
            for r in (r0, r1):  # the ranks' parameters stay equal to one device's
                err = np.abs(r["params"][step][name] - want).max()
                assert err <= 1e-3 * np.abs(want).max() + 1e-7, (step, name, err)
    jlosses, jparams = _jax_train(inputs, monkeypatch)
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=2e-4, atol=0)
    for step in range(2):
        for name, want in jparams[step].items():
            np.testing.assert_allclose(r0["params"][step][name], want.numpy(), atol=2e-4,
                                       rtol=0, err_msg=f"step {step} {name}")


def test_checkpoint_written_once_without_module_prefix(runs):
    """Only rank 0 writes; the keys are the model's own; the dp=2 file
    holds the weights of one device's run and loads into a one-device
    model."""
    inputs, ranks, one, tmp = runs
    assert [r["train"]["writes"] for r in ranks] == [1, 0]
    sd = torch.load(tmp / "dp2.ckpt", weights_only=False)["model_pos"]
    assert not any(k.startswith("module.") for k in sd)
    model = MixSTE2(MixSTEConfig(**W.CFG), device="cpu")
    model.load_state_dict(sd)
    for name, p in model.named_parameters():
        want = one["train"]["params"][-1][name]
        assert np.abs(p.detach().numpy() - want).max() <= 1e-3 * np.abs(want).max() + 1e-7


def _jax_evaluator(inputs, **kw):
    return JEvaluator(JD3DP(JD3DPConfig(model=JMixSTEConfig(**W.CFG), num_proposals=H,
                                        sampling_timesteps=K, **SYM)),
                      receptive_field=F, batch_size=4, mesh=jax_mesh(2), **LR, **kw)


@pytest.mark.parametrize("name", ["p2", "p2_device", "light"])
def test_evaluator_matches_jax_and_one_device(runs, name):
    inputs, ranks, one, _ = runs
    kw = {"p2": dict(p2=True), "p2_device": dict(p2_device=True), "light": dict(light=True)}[name]
    want = _jax_evaluator(inputs, **kw).evaluate(
        {"params": inputs["params"]}, JGen(*inputs["eval_data"], **GEN_LR),
        jax.random.PRNGKey(0), noise_provider=W.provider(11, H, K, 4))
    wants = (want.n, want.averages_mm(), want.averages_p2_mm())
    n0, p1_0, p2_0 = ranks[0]["evaluate"][name]
    assert n0 == wants[0] == one["evaluate"][name][0] == (4 + 3 + 2) * F
    for got in (ranks[0], ranks[1]):  # every rank returns the all-reduced result
        for i in (1, 2):
            g = got["evaluate"][name][i]
            assert set(g) == set(wants[i]) == set(one["evaluate"][name][i])
            assert set(g) == ((set(MODES) if name != "light" else {"P_Best"})
                              if i == 1 or name != "light" else set())
            for m in g:
                np.testing.assert_allclose(g[m], wants[i][m], atol=3.1e-4, rtol=0,
                                           err_msg=f"{name} {i} {m} vs JAX")
                np.testing.assert_allclose(g[m], one["evaluate"][name][i][m], atol=3.1e-4,
                                           rtol=0, err_msg=f"{name} {i} {m} vs one device")


def test_prediction_return_matches_jax(runs):
    inputs, ranks, one, _ = runs
    want = _jax_evaluator(inputs).evaluate(
        {"params": inputs["params"]}, JGen(*inputs["eval_data"], **GEN_LR),
        jax.random.PRNGKey(0), return_predictions=True, noise_provider=W.provider(12, H, K, 4))
    for got in (ranks[0]["evaluate"]["predictions"], ranks[1]["evaluate"]["predictions"]):
        assert got.shape == want.shape == (4, K, H, F, 17, 3)
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)
    np.testing.assert_allclose(ranks[0]["evaluate"]["predictions"],
                               one["evaluate"]["predictions"], atol=5e-4, rtol=0)


def test_evaluator_3dhp_matches_jax(runs):
    """70 frames: 3 windows a sequence at bs 2, the second micro-batch
    padded, so rank 1 holds only a pad row there. Rank 0 returns the
    exports, rank 1 none."""
    inputs, ranks, one, _ = runs
    jd = JD3DP(JD3DPConfig(model=JMixSTEConfig(**W.CFG), num_proposals=H, sampling_timesteps=K,
                           unit_scale=1000.0, **SYM_3DHP))
    p3, p2, valid = inputs["data_3dhp"]
    keys = list(p2)
    gen = JGen(None, [p3[k] for k in keys], [p2[k] for k in keys],
               kps_left=jdata.KPS_LEFT, kps_right=jdata.KPS_RIGHT, joints_left=jdata.KPS_LEFT,
               joints_right=jdata.KPS_RIGHT, valid_frames=[valid[k] for k in keys], keys=keys)
    want, wexp = JEvaluator3DHP(jd, receptive_field=F, batch_size=2, mesh=jax_mesh(2)).evaluate(
        {"params": inputs["params"]}, gen, jax.random.PRNGKey(0),
        noise_provider=W.provider(13, H, K, 2))
    (g0, e0), (g1, e1) = ranks[0]["evaluate_3dhp"], ranks[1]["evaluate_3dhp"]
    for g in (g0, g1, one["evaluate_3dhp"][0]):
        for m in ("P_Best", "P_Agg"):
            assert g[m].shape == (K,)
            np.testing.assert_allclose(g[m], want[m], atol=1e-3, rtol=0, err_msg=m)
    assert all(not e1[m] for m in MODES_3DHP)
    for m in MODES_3DHP:
        assert set(e0[m]) == set(wexp[m]) == set(keys)
        for k in keys:
            assert e0[m][k].shape == wexp[m][k].shape == (3, 17, 70, K)
            assert np.abs(e0[m][k] - wexp[m][k]).max() <= 0.05, (m, k)
            assert np.abs(e0[m][k] - one["evaluate_3dhp"][1][m][k]).max() <= 0.05, (m, k)


def test_sample_windows_matches_jax(runs):
    """7 windows at bs 3: rounded up to 4 under dp=2, two calls, the second
    padded by one row."""
    inputs, ranks, one, _ = runs
    jd = JD3DP(JD3DPConfig(model=JMixSTEConfig(**W.CFG), num_proposals=H, sampling_timesteps=K,
                           **SYM))
    w2d, w2d_f, bs = inputs["windows"]
    want = jwin.sample_windows(JaxKeyNoise(jd), {"params": inputs["params"]}, w2d, w2d_f, bs,
                               inputs["window_key"], mesh=jax_mesh(2))
    for got in (ranks[0]["sample_windows"], ranks[1]["sample_windows"]):
        assert got.shape == want.shape == (7, K, H, F, 17, 3)
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=0)

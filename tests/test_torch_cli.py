"""The port's H36M command line against the JAX package's, on the CPU:
flags, data preparation, the action-wise evaluation at fuse level 2
with the same weights and injected noise (3.1e-4 mm, the whole-pipeline
tolerance; `run_evaluation_against_jax` is shared with the level-5 and
feature-reuse tests), and a --debug training epoch whose checkpoints
--evaluate and --resume reload exactly."""

import re
import sys

import jax
import numpy as np
import pytest
import torch

from d3dp_tpu.cli import data_prep as jprep
from d3dp_tpu.cli import main_h36m as jmain
from d3dp_tpu.cli.arguments import parse_args as jparse
from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.models import MixSTEConfig as JMixSTEConfig
from d3dp_tpu.utils.misc import deterministic_random as j_deterministic_random
from d3dp_tpu_torch.cli import data_prep as tprep
from d3dp_tpu_torch.cli import main_h36m as tmain
from d3dp_tpu_torch.cli.arguments import parse_args as tparse
from d3dp_tpu_torch.eval import MODES
from d3dp_tpu_torch.train.checkpoint_io import latest_checkpoint, load_any
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from d3dp_tpu_torch.utils.logging import Logger, TensorBoardWriter
from d3dp_tpu_torch.utils.misc import deterministic_random
from d3dp_tpu_torch.utils.profiling import trace
from tests.test_torch_model import random_params

torch.set_num_threads(1)

SMALL = ["-d", "synthetic", "--nolog", "-f", "27", "-cs", "64", "-dep", "2", "-s", "27",
         "--synthetic-frames", "150", "--platform", "cpu", "--eval-batch-size", "4"]


@pytest.mark.parametrize("argv", [
    [],
    SMALL,
    SMALL + ["--evaluate", "best_epoch.ckpt", "-num_proposals", "5", "-sampling_timesteps", "3",
             "--fuse-level", "2", "--p2", "--by-subject", "-a", "Act0,Act2"],
    ["-k", "structured", "-e", "3", "-b", "108", "-lr", "1e-4", "-lrd", "0.99", "--coverlr",
     "-no-da", "--dtype", "bfloat16", "--attention", "pallas", "--fuse-level", "0", "-r", "auto",
     "--subset", "0.5", "--downsample", "2", "--debug", "--profile", "prof", "--seed", "7"],
    SMALL + ["--evaluate", "best_epoch.ckpt", "--fuse-level", "5"],
    SMALL + ["--evaluate", "best_epoch.ckpt", "--ddim-reuse", "3", "--ddim-reuse-tap", "1",
             "--ddim-reuse-adaptive", "0.05"],
    SMALL + ["--evaluate", "best_epoch.ckpt", "--p2-device"],
])
def test_parse_args_gives_jax_namespace(argv):
    assert vars(tparse(argv)) == vars(jparse(argv))


def _debug_epoch_log(directory, extra):
    """One --debug training epoch (-cf 1) into `directory`: its training
    log line without the elapsed time."""
    tmain.main(SMALL + ["-c", str(directory), "-b", "108", "--debug", "-e", "1", "-cf", "1",
                        *extra])
    return [re.sub(r"time [\d.]+ ", "", line)
            for line in (directory / "training_log.txt").read_text().splitlines()]


@pytest.mark.parametrize("flag", [
    ["--input-pipeline", "grain"], ["--ckpt-format", "orbax"],
])
def test_flags_not_ported_raise(flag, tmp_path):
    """The two flags the port once refused here parse to the JAX package's
    namespace and run: a --debug training epoch under each writes the
    default flags' log line, and its epoch checkpoint (epoch_1.orbax, a DCP
    directory, under orbax) loads to the default run's payload bit for bit
    (the thread-pool pipeline assembles the same batches)."""
    assert vars(tparse(SMALL + flag)) == vars(jparse(SMALL + flag))
    got = _debug_epoch_log(tmp_path / "flag", flag)
    assert got == _debug_epoch_log(tmp_path / "default", []) and got[0].startswith("[1] ")
    ext = "orbax" if "orbax" in flag else "ckpt"
    a = load_any(str(tmp_path / "flag" / f"epoch_1.{ext}"))
    b = load_any(str(tmp_path / "default" / "epoch_1.ckpt"))
    assert a.keys() == b.keys() and a["epoch"] == b["epoch"] == 1 and a["lr"] == b["lr"]
    for k, v in b["model"].items():
        assert torch.equal(a["model"][k], v), k
    for i, st in b["optimizer"]["state"].items():
        for key, val in st.items():
            assert torch.equal(a["optimizer"]["state"][i][key], val), (i, key)
    assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
    for x, y in zip(a["random_state"].get_state(), b["random_state"].get_state()):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("flag", [
    ["--dp", "2"], ["--multihost"], ["--coordinator-address", "localhost:1234"],
    ["--coordinator-address", "localhost:1234", "--num-hosts", "2", "--host-id", "1"],
    ["--tp", "2"], ["--dp", "2", "--tp", "2"],
])
def test_parallel_flags_give_jax_namespace(flag):
    """The data-parallel, tensor-parallel and multi-host flags parse as the
    JAX package's (their runs: tests/test_torch_cli_dp.py,
    tests/test_torch_cli_tp.py)."""
    assert vars(tparse(SMALL + flag)) == vars(jparse(SMALL + flag))


def test_host_flags_need_the_coordinator(capsys):
    for parse in (tparse, jparse):
        with pytest.raises(SystemExit):
            parse(SMALL + ["--num-hosts", "2"])
    assert "require --coordinator-address" in capsys.readouterr().err


@pytest.mark.parametrize("flags,want", [
    ([], (1, 2, 0.0)),
    (["--ddim-reuse", "1"], (1, 2, 0.0)),
    (["--ddim-reuse", "2", "--ddim-reuse-tap", "9", "--ddim-reuse-adaptive", "0.5"], (2, 2, 0.5)),
    (["--ddim-reuse", "3", "--ddim-reuse-tap", "0"], (3, 1, 0.0)),
])
def test_reuse_flags_map_as_in_jax(flags, want):
    """--ddim-reuse N -> reuse_interval max(N, 1), the tap clamped to
    1..-dep, the adaptive threshold as given; on the eval D3DP only."""
    args = tparse(SMALL + flags)
    data = tprep.prepare_data(args)
    train, valid, ev = tmain._build_models(args, data, "cpu")
    assert (ev.cfg.reuse_interval, ev.cfg.reuse_tap, ev.cfg.reuse_tau) == want
    assert train.cfg.reuse_interval == valid.cfg.reuse_interval == 1


def test_attention_xla_runs_only_on_the_cpu(capsys):
    assert tparse(SMALL + ["--attention", "xla"]).attention == "xla"
    with pytest.raises(SystemExit):
        tparse(["--attention", "xla"])
    assert "only on the CPU" in capsys.readouterr().err
    # the inert flags are accepted
    tparse(SMALL + ["--jax-cache", "", "--num-virtual-devices", "8", "-gpu", "1"])


@pytest.mark.parametrize("keypoints", ["cpn_ft_h36m_dbb", "structured"])
def test_prepare_synthetic_and_fetch_bit_exact(keypoints):
    argv = ["-d", "synthetic", "--synthetic-frames", "300", "-k", keypoints, "--platform", "cpu"]
    want, got = jprep.prepare_data(jparse(argv)), tprep.prepare_data(tparse(argv))
    assert got.subjects() == want.subjects()
    for field in ("kps_left", "kps_right", "joints_left", "joints_right", "num_joints", "fps",
                  "keypoints_metadata"):
        assert getattr(got, field) == getattr(want, field), field
    assert np.array_equal(got.skeleton.parents(), want.skeleton.parents())
    for s in want.subjects():
        assert got.actions_of(s) == want.actions_of(s)
    for kw in (dict(), dict(subset=0.5), dict(downsample=2), dict(action_filter=["Act1"])):
        subjects = ["S1", "S9"]
        for a, b in zip(tprep.fetch(got, subjects, **kw), jprep.fetch(want, subjects, **kw)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y)
    for data in ("a", "300", "1200", "S9 Walking"):
        assert deterministic_random(0, 77, data) == j_deterministic_random(0, 77, data)


def test_prepare_h36m_matches_jax(rng, tmp_path, monkeypatch):
    """A small data_3d/data_2d pair in the original npz layout."""
    (tmp_path / "data").mkdir()
    pos3d, pos2d = {}, {}
    for s in ("S1", "S9"):
        pos3d[s], pos2d[s] = {}, {}
        for a, T in (("Walking 1", 30), ("Sitting", 20)):
            pos3d[s][a] = (rng.randn(T, 32, 3) * 0.5 + [0, 0, 5]).astype(np.float32)
            pos2d[s][a] = [(rng.rand(T + 2, 17, 2) * 1000).astype(np.float32) for _ in range(4)]
    np.savez(tmp_path / "data" / "data_3d_h36m.npz", positions_3d=pos3d)
    meta = {"layout_name": "h36m", "num_joints": 17,
            "keypoints_symmetry": [[4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]]}
    np.savez(tmp_path / "data" / "data_2d_h36m_cpn.npz", positions_2d=pos2d, metadata=meta)
    monkeypatch.chdir(tmp_path)
    argv = ["-k", "cpn", "--platform", "cpu"]
    want, got = jprep.prepare_data(jparse(argv)), tprep.prepare_data(tparse(argv))
    assert (got.kps_left, got.joints_left, got.fps) == (want.kps_left, want.joints_left, want.fps)
    for s in ("S1", "S9"):
        for a in ("Walking 1", "Sitting"):
            for x, y in zip(got.keypoints[s][a], want.keypoints[s][a]):
                assert np.array_equal(x, y)
            for x, y in zip(got.poses_3d[s][a], want.poses_3d[s][a]):
                assert x.shape == (pos3d[s][a].shape[0], 17, 3)
                np.testing.assert_allclose(x, y, atol=1e-6, rtol=0)
        for cg, cw in zip(got.cameras[s], want.cameras[s]):
            assert np.array_equal(cg["intrinsic"], cw["intrinsic"])


def _provider(seed, H, K, F):
    rng = np.random.RandomState(seed)

    def provider(n):
        img0 = rng.randn(n, H, F, 17, 3).astype(np.float32)
        return img0, rng.randn(K, n, H, F, 17, 3).astype(np.float32)
    return provider


def _strip_numbers(path):
    return [re.sub(r"-?\d+\.\d+", "#", line) for line in open(path).read().splitlines()]


def run_evaluation_against_jax(tmp_path, level, K=2, extra=(), **reuse):
    """run_evaluation of both command lines at `--fuse-level level` with
    the `extra` flags, same weights and injected noise: 3.1e-4 mm per
    action, mode and step (Protocol-2 with `--p2-device`: rtol 2e-3, atol
    5e-3 mm, tests/test_eval.py's bound for the device SVD), and log lines
    equal but for their numbers.
    `reuse`: the JAX D3DPConfig's feature-reuse fields that `extra` sets
    (the JAX test builds its D3DP itself; the port's comes from its own
    `_build_models`)."""
    H, F = 2, 27
    eval_argv = SMALL + ["-num_proposals", str(H), "-sampling_timesteps", str(K),
                         "--fuse-level", str(level), "--p2", *extra]
    jargs = jparse(eval_argv + ["-c", str(tmp_path / "jax")])
    targs = tparse(eval_argv + ["-c", str(tmp_path / "torch")])
    for a in (jargs, targs):
        (tmp_path / a.checkpoint.split("/")[-1]).mkdir()
    jdata, tdata = jprep.prepare_data(jargs), tprep.prepare_data(targs)
    jcfg = JMixSTEConfig(num_frames=F, embed_dim=64, depth=2, attention_impl="pallas",
                         fuse_level=level)
    params = random_params(jcfg, seed=4, scale=0.02)
    jd = JD3DP(JD3DPConfig(model=jcfg, num_proposals=H, sampling_timesteps=K,
                           joints_left=tuple(jdata.joints_left),
                           joints_right=tuple(jdata.joints_right), **reuse))
    want = jmain.run_evaluation(jargs, jdata, jd, {"params": params}, jax.random.PRNGKey(0),
                                noise_provider=_provider(5, H, K, F))
    _, _, td = tmain._build_models(targs, tdata, "cpu")
    td.model.load_state_dict(state_dict_from_flax(params, 2))
    got = tmain.run_evaluation(targs, tdata, td, noise_provider=_provider(5, H, K, F))

    assert list(got) == list(want) == ["Act0", "Act1", "Act2"]
    for action in want:
        g, w = got[action], want[action]
        assert g.n == w.n
        for read, tol in (("averages_mm", dict(atol=3.1e-4, rtol=0)),
                          ("averages_p2_mm", dict(atol=5e-3, rtol=2e-3) if "--p2-device" in extra
                           else dict(atol=3.1e-4, rtol=0))):
            gm, wm = getattr(g, read)(), getattr(w, read)()
            for m in MODES:
                assert np.isfinite(gm[m]).all()
                np.testing.assert_allclose(gm[m], wm[m], err_msg=f"{action} {read} {m}", **tol)
    log = f"h36m_test_log_H{H}_K{K}.txt"
    lines = _strip_numbers(tmp_path / "torch" / log)
    assert lines == _strip_numbers(tmp_path / "jax" / log) and len(lines) > 3 * (1 + 8 * K)
    return got


def test_run_evaluation_level_2_matches_jax(tmp_path):
    run_evaluation_against_jax(tmp_path, 2)


def test_run_evaluation_p2_device_matches_jax(tmp_path):
    """--p2-device: Protocol-2 on the device in both packages."""
    run_evaluation_against_jax(tmp_path, 4, extra=("--p2-device",))


def test_debug_training_checkpoints_reload(tmp_path, monkeypatch):
    """One --debug epoch writes epoch_1 and best_epoch; --resume restores
    weights, AdamW state, lr, epoch and the generator's random state, and
    --evaluate samples with the trained weights."""
    built, gens = [], []
    build_models = tmain._build_models

    def build(*a, **k):
        built.append(build_models(*a, **k))
        return built[-1]

    class Recording(tmain.ChunkedGenerator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            gens.append(self)

    monkeypatch.setattr(tmain, "_build_models", build)
    monkeypatch.setattr(tmain, "ChunkedGenerator", Recording)
    argv = SMALL + ["-c", str(tmp_path), "-b", "108", "--debug"]
    opt = tmain.main(argv + ["-e", "1", "-cf", "1"])
    trained = {k: v.clone() for k, v in built[-1][0].model.state_dict().items()}
    saved_rs = gens[-1].random_state().get_state()
    for name in ("epoch_1.ckpt", "best_epoch.ckpt"):
        ck = load_any(str(tmp_path / name))
        assert ck["epoch"] == 1 and ck["lr"] == pytest.approx(6e-5 * 0.993)
    assert latest_checkpoint(str(tmp_path)).endswith("epoch_1.ckpt")

    resumed = tmain.main(argv + ["-r", "epoch_1.ckpt", "-e", "1"])  # epoch 1 of 1: no step
    for k, v in built[-1][0].model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    a, b = opt.state_dict(), resumed.state_dict()
    assert a["param_groups"] == b["param_groups"]
    for i, st in a["state"].items():
        for key, val in st.items():
            assert torch.equal(val, b["state"][i][key]), (i, key)
    for x, y in zip(saved_rs, gens[-1].random_state().get_state()):
        assert np.array_equal(x, y)
    with open(tmp_path / "training_log.txt") as f:
        assert sum(line.startswith("[") for line in f) == 1  # the resumed run trained no epoch

    results = tmain.main(argv + ["--evaluate", "best_epoch.ckpt", "-num_proposals", "2",
                                 "-sampling_timesteps", "2", "--fuse-level", "1"])
    for k, v in built[-1][2].model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    for r in results.values():
        p1 = r.averages_mm()
        assert all(np.isfinite(p1[m]).all() for m in MODES)
        assert np.all(p1["J_Best"] <= p1["P_Best"] + 1e-9)


def test_logging_and_profiling_utils(tmp_path, capsys):
    log = Logger(str(tmp_path / "out.log"))
    log.write("hello\n")
    log.flush()
    assert "hello" in capsys.readouterr().out
    assert (tmp_path / "out.log").read_text() == "hello\n"
    before = set(sys.modules)
    try:
        w = TensorBoardWriter(str(tmp_path / "tb"))
        w.add_scalar("a", 1.0, 1)
        w.add_text("t", "x")
        w.close()
    finally:
        # the writer's backends leave sys.modules as they found it: a later
        # test in this process that blocks their import must not find them
        for name in set(sys.modules) - before:
            if name.startswith(("torch.utils.tensorboard", "tensorboardX")):
                del sys.modules[name]
    TensorBoardWriter(str(tmp_path / "off"), enabled=False).add_scalar("a", 1.0, 1)
    with trace(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0

"""The port's command lines at `--platform cpu --dp 2` (two gloo ranks, which
the command line starts itself) against `--dp 1`, on the CPU: the fast
counterpart of tests/test_cli_sharded.py (marked slow), at embed 64, depth
2, F=27 on the synthetic data. Same data and seed, so the two runs differ
only in the order of the reductions: training losses within 1e-5
relative, the evaluation's errors within 3.1e-4 mm (the whole-pipeline
tolerance), the 3DHP exports within 0.05 mm and the sampled predictions
within 5e-4. Logs, checkpoints and exports are written once, by rank 0; a
dp=2 checkpoint resumes at dp=1.
"""

import os
import re
import shutil

import numpy as np
import pytest
import scipy.io as sio
import torch

from d3dp_tpu_torch.cli import main_3dhp, main_draw, main_h36m
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.in_the_wild import inference_video
from d3dp_tpu_torch.models import MixSTEConfig
from d3dp_tpu_torch.train.checkpoint_io import save_checkpoint

torch.set_num_threads(1)

BASE = ["-d", "synthetic", "--nolog", "-f", "27", "-cs", "64", "-dep", "2", "-s", "27",
        "--platform", "cpu", "-b", "108", "--eval-batch-size", "4"]
EVAL = ["-num_proposals", "2", "-sampling_timesteps", "2"]
MESH = "INFO: 2-device mesh (dp=2, tp=1)"


def run(main, capfd, argv):
    """main(argv), with the output of every rank's process."""
    main(argv)
    return capfd.readouterr().out


def train_losses(out):
    """[(train, valid), ...] per epoch from the reference-format log line."""
    rows = re.findall(r"3d_train ([\d.]+) 3d_pos_valid ([\d.]+)", out)
    assert rows, out[-2000:]
    return np.asarray(rows, dtype=np.float64)


def eval_errors(out):
    rows = re.findall(r"step (\d+) : Protocol #(\d) Error \(MPJPE\) (\w+): ([\d.]+) mm", out)
    assert rows, out[-2000:]
    return {(s, p, m): float(v) for s, p, m, v in rows}


def test_h36m_trains_resumes_and_evaluates_as_one_device(tmp_path, capfd):
    outs = {}
    for dp in ("1", "2"):
        c = str(tmp_path / f"dp{dp}")
        argv = BASE + ["--synthetic-frames", "150", "-c", c, "--dp", dp]
        outs[dp] = (run(main_h36m.main, capfd, argv + ["-e", "2", "-cf", "1"]),
                    run(main_h36m.main, capfd, argv + ["-e", "3", "-cf", "1", "-r", "auto"]),
                    run(main_h36m.main, capfd, argv + ["--evaluate", "epoch_2.ckpt", "--p2"]
                        + EVAL))
    assert all(MESH in o for o in outs["2"]) and not any("mesh" in o for o in outs["1"])
    for i in (0, 1):
        l1, l2 = train_losses(outs["1"][i]), train_losses(outs["2"][i])
        assert l1.shape == l2.shape == ((2, 2) if i == 0 else (1, 2))
        np.testing.assert_allclose(l2, l1, rtol=1e-5, atol=0)
    e1, e2 = eval_errors(outs["1"][2]), eval_errors(outs["2"][2])
    assert set(e1) == set(e2) and len(e1) == 2 * 2 * 4  # K, P1 and P2, four modes
    assert all(abs(e2[c] - e1[c]) <= 3.1e-4 for c in e1), (e1, e2)
    # every file once: the same files, the same log lines
    names = sorted(os.listdir(tmp_path / "dp1"))
    assert names == sorted(os.listdir(tmp_path / "dp2"))
    for name in ("training_log.txt", "h36m_test_log_H2_K2.txt"):
        lines = [open(tmp_path / d / name).read().count("\n") for d in ("dp1", "dp2")]
        assert lines[0] == lines[1] > 0, name
    # the dp=2 checkpoint of epoch 2 resumed on one device: epoch 3 as at dp=2
    shutil.copytree(tmp_path / "dp2", tmp_path / "to1")
    os.remove(tmp_path / "to1" / "epoch_3.ckpt")
    out = run(main_h36m.main, capfd, BASE + ["--synthetic-frames", "150", "-c",
                                             str(tmp_path / "to1"), "--dp", "1", "-e", "3",
                                             "-cf", "1", "-r", "epoch_2.ckpt"])
    np.testing.assert_allclose(train_losses(out), train_losses(outs["2"][1]), rtol=1e-5, atol=0)


def test_render_export_as_one_device(tmp_path, capfd):
    got = {}
    for dp in ("1", "2"):
        export = str(tmp_path / f"render{dp}.npy")
        out = run(main_h36m.main, capfd, BASE + [
            "--synthetic-frames", "150", "-c", str(tmp_path / dp), "--dp", dp, "--render",
            "--viz-subject", "S9", "--viz-action", "Act0 1", "--viz-export", export, "-b", "4"]
            + EVAL)
        assert (MESH in out) == (dp == "2")
        got[dp] = np.load(export)
    assert got["1"].shape == got["2"].shape and np.isfinite(got["2"]).all()
    np.testing.assert_allclose(got["2"], got["1"], atol=5e-4, rtol=0)


def test_3dhp_trains_and_evaluates_as_one_device(tmp_path, capfd):
    outs = {}
    for dp in ("1", "2"):
        argv = BASE + ["--synthetic-frames", "120", "-c", str(tmp_path / dp), "--dp", dp]
        outs[dp] = (run(main_3dhp.main, capfd, argv + ["-e", "1", "-cf", "1"]),
                    run(main_3dhp.main, capfd, argv + ["--evaluate", "epoch_1.ckpt",
                                                       "--eval-batch-size", "2"] + EVAL))
    assert all(MESH in o for o in outs["2"])
    np.testing.assert_allclose(train_losses(outs["2"][0]), train_losses(outs["1"][0]),
                               rtol=1e-5, atol=0)
    e1, e2 = eval_errors(outs["1"][1]), eval_errors(outs["2"][1])
    assert set(e1) == set(e2) and len(e1) == 2 * 2  # K, P-Best and P-Agg
    assert all(abs(e2[c] - e1[c]) <= 1e-3 for c in e1), (e1, e2)
    for mode in ("P_Agg", "P_Best", "J_Best", "J_Agg"):
        a = sio.loadmat(tmp_path / "1" / f"inference_data_{mode}.mat")
        b = sio.loadmat(tmp_path / "2" / f"inference_data_{mode}.mat")
        for seq in ("TS1", "TS2"):
            assert a[seq].shape == b[seq].shape == (3, 17, 120, 2)
            assert np.abs(a[seq] - b[seq]).max() <= 0.05, (mode, seq)


def test_draw_and_in_the_wild_as_one_device(tmp_path, capfd, monkeypatch):
    """main_draw's plots and the in-the-wild pipeline's exports, written by
    rank 0 at dp=2, against one device's; so are the values main_draw.main
    and inference_video return (rank 0's, from its worker process)."""
    cv2 = pytest.importorskip("cv2")
    vw = cv2.VideoWriter(str(tmp_path / "vid.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 25,
                         (64, 48))
    for _ in range(60):
        vw.write(np.full((48, 64, 3), 128, np.uint8))
    vw.release()
    np.savez(tmp_path / "vid.npz",
             kpts=(np.random.RandomState(0).rand(60, 17, 2) * 40).astype(np.float32))
    td = D3DP(D3DPConfig(model=MixSTEConfig(num_frames=27, embed_dim=64, depth=2)),
              device="cpu", seed=3)
    save_checkpoint(str(tmp_path / "wild.ckpt"), epoch=1, lr=1e-4, model=td.model)
    wild, drawn, returned = {}, {}, {}
    for dp in ("1", "2"):
        (tmp_path / dp).mkdir()
        monkeypatch.chdir(tmp_path / dp)
        drawn[dp] = main_draw.main(BASE + ["--synthetic-frames", "150", "--dp", dp,
                                           "--viz-limit", "2"] + EVAL)
        assert (MESH in capfd.readouterr().out) == (dp == "2")
        returned[dp] = inference_video(
            str(tmp_path / "vid.mp4"), "npz", checkpoint=str(tmp_path / "wild.ckpt"),
            argv=["-f", "27", "-cs", "64", "-dep", "2", "--platform", "cpu", "-b", "108",
                  "--dp", dp, "--viz-limit", "1"] + EVAL)
        wild[dp] = [np.load(tmp_path / dp / "outputs" / "vid" / name) for name in
                    ("test_3d_vid_output.npy", "test_3d_output_vid_postprocess.npy")]
        np.testing.assert_array_equal(returned[dp], wild[dp][1])
        assert sorted(os.listdir(tmp_path / dp / "plot" / "synthetic" / "S9_Act0_1_0")) == \
            ["frame_0000.png", "frame_0001.png"]
        assert sorted(os.listdir(tmp_path / dp / "outputs" / "vid" / "vid_wild_0")) == \
            ["frame_0000.png"]
    for a, b in zip(wild["1"], wild["2"]):
        assert a.shape == b.shape == (2, 2, 60, 17, 3)
        np.testing.assert_allclose(b, a, atol=5e-4, rtol=0)
    assert drawn["1"].keys() == drawn["2"].keys()
    assert drawn["2"]["preds"].shape == (2, 2, 50, 17, 3)
    for key in ("preds", "pred_2d", "gt"):
        np.testing.assert_allclose(drawn["2"][key], drawn["1"][key], atol=5e-4, rtol=0)


def test_dp_beyond_the_cards_is_refused(monkeypatch):
    """--dp 2 on a one-card box: JAX's auto_mesh message, before any process
    starts."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"^--dp 2 x --tp 1 exceeds the 1 visible devices$"):
        main_h36m.main(BASE[:BASE.index("--platform")] + ["--dp", "2"])

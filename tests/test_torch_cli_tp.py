"""The port's command lines at `--platform cpu --tp 2` (two gloo ranks, one
tensor-parallel group, which the command line starts itself) and at `--dp
2 --tp 2` (four), against `--tp 1`, on the CPU: the counterpart of
tests/test_cli_sharded.py (marked slow), at embed 64, depth 2, F=27 on the
synthetic data, as tests/test_torch_cli_dp.py holds `--dp 2`. The runs
differ only in the order of the reductions: training losses within 1e-5
relative, the evaluation's errors within 3.1e-4 mm, the 3DHP exports within
0.05 mm and the sampled predictions within 5e-4. The same files and log
lines come out, apart from the mesh line; checkpoints move between tp 1
and tp 2 both ways.
"""

import os
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
from tests.test_torch_cli_dp import BASE, EVAL, eval_errors, run, train_losses

torch.set_num_threads(1)

MESH = {"2": "INFO: 2-device mesh (dp=1, tp=2)", "2x2": "INFO: 4-device mesh (dp=2, tp=2)"}
FLAGS = {"1": ["--tp", "1"], "2": ["--tp", "2"], "2x2": ["--dp", "2", "--tp", "2"]}


def test_h36m_trains_resumes_and_evaluates_as_tp1(tmp_path, capfd):
    outs = {}
    for tp in ("1", "2"):
        c = str(tmp_path / f"tp{tp}")
        argv = BASE + ["--synthetic-frames", "150", "-c", c] + FLAGS[tp]
        outs[tp] = (run(main_h36m.main, capfd, argv + ["-e", "2", "-cf", "1"]),
                    run(main_h36m.main, capfd, argv + ["-e", "3", "-cf", "1", "-r", "auto"]),
                    run(main_h36m.main, capfd, argv + ["--evaluate", "epoch_2.ckpt", "--p2"]
                        + EVAL))
    assert all(MESH["2"] in o for o in outs["2"]) and not any("mesh" in o for o in outs["1"])
    for i in (0, 1):
        l1, l2 = train_losses(outs["1"][i]), train_losses(outs["2"][i])
        assert l1.shape == l2.shape == ((2, 2) if i == 0 else (1, 2))
        np.testing.assert_allclose(l2, l1, rtol=1e-5, atol=0)
    e1, e2 = eval_errors(outs["1"][2]), eval_errors(outs["2"][2])
    assert set(e1) == set(e2) and len(e1) == 2 * 2 * 4  # K, P1 and P2, four modes
    assert all(abs(e2[c] - e1[c]) <= 3.1e-4 for c in e1), (e1, e2)
    # the same files and log lines; the output apart from the mesh line
    names = sorted(os.listdir(tmp_path / "tp1"))
    assert names == sorted(os.listdir(tmp_path / "tp2"))
    for name in ("training_log.txt", "h36m_test_log_H2_K2.txt"):
        lines = [open(tmp_path / d / name).read().count("\n") for d in ("tp1", "tp2")]
        assert lines[0] == lines[1] > 0, name
    for o1, o2 in zip(outs["1"], outs["2"]):
        assert len(o2.splitlines()) >= len(o1.splitlines()) + 1
        assert [ln.split(":")[0] for ln in o1.splitlines() if ln.startswith("INFO")] == \
            [ln.split(":")[0] for ln in o2.splitlines() if ln.startswith("INFO")
             and "mesh" not in ln]
    # the epoch-2 checkpoints resumed at the other topology: epoch 3 as there
    for src, dst in (("tp2", "1"), ("tp1", "2")):
        shutil.copytree(tmp_path / src, tmp_path / f"{src}to{dst}")
        os.remove(tmp_path / f"{src}to{dst}" / "epoch_3.ckpt")
        out = run(main_h36m.main, capfd, BASE + ["--synthetic-frames", "150", "-c",
                                                 str(tmp_path / f"{src}to{dst}"), "-e", "3",
                                                 "-cf", "1", "-r", "epoch_2.ckpt"] + FLAGS[dst])
        np.testing.assert_allclose(train_losses(out), train_losses(outs[src[2:]][1]),
                                   rtol=1e-5, atol=0)


@pytest.mark.parametrize("tp,levels", [("2", ("2", "5")), ("2x2", ("4",))])
def test_evaluate_and_render_as_tp1(tmp_path, capfd, tp, levels):
    """--evaluate at the fuse levels whose flows split differently (level 2:
    the block's partial form with K5's; 4: the stage's, also the default
    level of the test above; 5: the trunk on gathered weights) and
    --render's export (the seeded weights), against tp 1."""
    c = str(tmp_path / "ck")
    run(main_h36m.main, capfd, BASE + ["--synthetic-frames", "150", "-c", c, "-e", "1",
                                       "-cf", "1"])
    for level in levels:
        outs = {t: run(main_h36m.main, capfd, BASE + [
            "--synthetic-frames", "150", "-c", c, "--evaluate", "epoch_1.ckpt",
            "--fuse-level", level] + EVAL + FLAGS[t]) for t in ("1", tp)}
        assert MESH[tp] in outs[tp]
        e1, e2 = eval_errors(outs["1"]), eval_errors(outs[tp])
        assert set(e1) == set(e2) and all(abs(e2[k] - e1[k]) <= 3.1e-4 for k in e1), level
    got = {}
    for t in ("1", tp):
        export = str(tmp_path / f"render{t}.npy")
        out = run(main_h36m.main, capfd, BASE + [
            "--synthetic-frames", "150", "-c", c, "--render",
            "--viz-subject", "S9", "--viz-action", "Act0 1", "--viz-export", export, "-b", "4"]
            + EVAL + FLAGS[t])
        assert (MESH[tp] in out) == (t == tp)
        got[t] = np.load(export)
    assert got["1"].shape == got[tp].shape and np.isfinite(got[tp]).all()
    np.testing.assert_allclose(got[tp], got["1"], atol=5e-4, rtol=0)


def test_3dhp_trains_and_evaluates_as_tp1(tmp_path, capfd):
    outs = {}
    for tp in ("1", "2"):
        argv = BASE + ["--synthetic-frames", "120", "-c", str(tmp_path / tp)] + FLAGS[tp]
        outs[tp] = (run(main_3dhp.main, capfd, argv + ["-e", "1", "-cf", "1"]),
                    run(main_3dhp.main, capfd, argv + ["--evaluate", "epoch_1.ckpt",
                                                       "--eval-batch-size", "2"] + EVAL))
    assert all(MESH["2"] in o for o in outs["2"])
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


def test_draw_and_in_the_wild_as_tp1(tmp_path, capfd, monkeypatch):
    """main_draw's hypotheses and the in-the-wild pipeline's exports at tp
    2 against tp 1 (plots only where cv2 reads the video)."""
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
    wild, drawn = {}, {}
    for tp in ("1", "2"):
        (tmp_path / tp).mkdir()
        monkeypatch.chdir(tmp_path / tp)
        drawn[tp] = main_draw.main(BASE + ["--synthetic-frames", "150", "--viz-limit", "1"]
                                   + EVAL + FLAGS[tp])
        assert (MESH["2"] in capfd.readouterr().out) == (tp == "2")
        returned = inference_video(
            str(tmp_path / "vid.mp4"), "npz", checkpoint=str(tmp_path / "wild.ckpt"),
            argv=["-f", "27", "-cs", "64", "-dep", "2", "--platform", "cpu", "-b", "108",
                  "--viz-limit", "1"] + EVAL + FLAGS[tp])
        wild[tp] = np.load(tmp_path / tp / "outputs" / "vid"
                           / "test_3d_output_vid_postprocess.npy")
        np.testing.assert_array_equal(returned, wild[tp])
    assert wild["1"].shape == wild["2"].shape == (2, 2, 60, 17, 3)
    np.testing.assert_allclose(wild["2"], wild["1"], atol=5e-4, rtol=0)
    for key in ("preds", "pred_2d", "gt"):
        np.testing.assert_allclose(drawn["2"][key], drawn["1"][key], atol=5e-4, rtol=0)


def test_tp_beyond_the_heads_is_refused(tmp_path):
    """--tp 3 does not divide MixSTE2's 8 heads: every rank refuses before
    any sampling or training."""
    with pytest.raises(Exception, match="must divide the 8 attention heads"):
        main_h36m.main(BASE + ["--synthetic-frames", "150", "-c", str(tmp_path), "-e", "1",
                               "--tp", "3"])

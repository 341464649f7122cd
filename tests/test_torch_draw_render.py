"""The port's drawing and rendering paths against the JAX package's, on the
CPU: UnchunkedGenerator's in-generator flip, Evaluator.evaluate's
prediction return, `--render` and its exports and animations, main_draw's
hypothesis collector and command line, and the plots of
viz/visualization.py.

Tolerances: sampled predictions 5e-4 (the DDIM-replay bound of
tests/test_torch_model.py); the generator's yields equal; the plots'
pixels equal (the same matplotlib calls on the same numpy inputs).
"""

import os

import jax
import matplotlib.image as mpimg
import numpy as np
import pytest
import torch

from d3dp_tpu.cli import data_prep as jprep
from d3dp_tpu.cli import main_draw as jdraw
from d3dp_tpu.cli import main_h36m as jmain
from d3dp_tpu.cli import render as jrender
from d3dp_tpu.cli.arguments import parse_args as jparse
from d3dp_tpu.data import generators as jgen
from d3dp_tpu.data import synthetic as jsyn
from d3dp_tpu.eval import Evaluator as JEvaluator
from d3dp_tpu.viz import visualization as jviz
from d3dp_tpu_torch.cli import data_prep as tprep
from d3dp_tpu_torch.cli import main_draw as tdraw
from d3dp_tpu_torch.cli import main_h36m as tmain
from d3dp_tpu_torch.cli import render as trender
from d3dp_tpu_torch.cli.arguments import parse_args as tparse
from d3dp_tpu_torch.data import generators as tgen
from d3dp_tpu_torch.data.windowing import stitch_windows
from d3dp_tpu_torch.eval import Evaluator
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from d3dp_tpu_torch.viz import visualization as tviz
from tests.test_torch_model import random_params
from tests.test_torch_wild import TOL, JaxKeyNoise, TorchKeyNoise, _grey_video, _pair

torch.set_num_threads(1)

F, H, K = 9, 2, 2
LR = dict(kps_left=list(jsyn.JOINTS_LEFT), kps_right=list(jsyn.JOINTS_RIGHT))
GEN_LR = dict(LR, joints_left=list(jsyn.JOINTS_LEFT), joints_right=list(jsyn.JOINTS_RIGHT))
SMALL = ["-d", "synthetic", "--nolog", "-f", str(F), "-cs", "64", "-dep", "2",
         "--synthetic-frames", "120", "--platform", "cpu", "-num_proposals", str(H),
         "-sampling_timesteps", str(K)]
RENDER = ["--render", "--viz-subject", "S9", "--viz-action", "Act0 1"]


def _provider(seed=11):
    rng = np.random.RandomState(seed)

    def provider(n):
        return (rng.randn(n, H, F, 17, 3).astype(np.float32),
                rng.randn(K, n, H, F, 17, 3).astype(np.float32))
    return provider


def _equal_items(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("case", ["cams_3d", "no_3d", "valid_keys", "augment_off"])
def test_unchunked_generator_matches_jax(case):
    """With augment the flipped copy stacked after the original, the camera's
    cx and p1 negated; set_augment toggles it; the 3DHP (valid, key) yield
    kept."""
    cams, p3, p2 = jsyn.make_dataset(seed=2, lengths=(30, 11))
    kw = dict(GEN_LR, augment=case != "augment_off")
    if case == "no_3d":
        cams, p3 = None, None
    if case == "valid_keys":
        kw.update(valid_frames=[np.ones(30), np.arange(11) % 2], keys=["TS1", "TS2"])
    got = tgen.UnchunkedGenerator(cams, p3, p2, **kw)
    want = jgen.UnchunkedGenerator(cams, p3, p2, **kw)
    assert got.augment_enabled() == want.augment_enabled() == (case != "augment_off")
    assert got.num_frames() == want.num_frames() == 41
    for _ in range(2):  # before and after toggling
        items = list(zip(got.next_epoch(), want.next_epoch()))
        assert len(items) == 2
        for g, w in items:
            _equal_items(g, w)
        got.set_augment(not got.augment_enabled())
        want.set_augment(not want.augment_enabled())


@pytest.mark.parametrize("lengths", [(40, 5), (5, 40)])
def test_evaluate_return_predictions_matches_jax(lengths):
    """All windows of the first sequence (40 frames: 5 windows in 3
    micro-batches of 2, the last padded; 5 frames: one edge-padded window),
    root-zeroed, under the same provider noise."""
    jd, params, td, _ = _pair(joints_left=tuple(jsyn.JOINTS_LEFT),
                              joints_right=tuple(jsyn.JOINTS_RIGHT))
    data = jsyn.make_dataset(seed=1, lengths=lengths)
    ekw = dict(receptive_field=F, batch_size=2, **LR)
    want = JEvaluator(jd, **ekw).evaluate(params, jgen.UnchunkedGenerator(*data, **GEN_LR),
                                          jax.random.PRNGKey(0), return_predictions=True,
                                          noise_provider=_provider())
    got = Evaluator(td, **ekw).evaluate(tgen.UnchunkedGenerator(*data), return_predictions=True,
                                        noise_provider=_provider())
    W = -(-lengths[0] // F)
    assert got.shape == want.shape == (W, K, H, F, 17, 3) and isinstance(got, np.ndarray)
    assert not got[..., 0, :].any()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def _render_pair(extra):
    """(port args, data, D3DP; JAX args, data, D3DP, params) of one render
    command line with the same weights."""
    argv = SMALL + RENDER + ["-b", "2"] + extra
    targs, jargs = tparse(argv), jparse(argv + ["--dp", "1"])
    tdata, jdata = tprep.prepare_data(targs), jprep.prepare_data(jargs)
    _, _, td = tmain._build_models(targs, tdata, "cpu")
    _, _, jd = jmain._build_models(jargs, jdata)
    params = random_params(jd.cfg.model, seed=7, scale=0.02)
    td.model.load_state_dict(state_dict_from_flax(params, 2))
    return targs, tdata, td, jargs, jdata, jd, {"params": params}


def test_render_export_matches_jax(tmp_path, monkeypatch):
    """--render --viz-export: the stitched last-step first-hypothesis
    sequence (Ftot, 17, 3) of JAX's run_render and the port's under the
    same provider noise; it is stitch_windows of the evaluator's
    prediction return."""
    targs, tdata, td, jargs, jdata, jd, params = _render_pair(
        ["--viz-export", str(tmp_path / "t.npy")])
    jargs.viz_export = str(tmp_path / "j.npy")

    class Injected(JEvaluator):
        def evaluate(self, *a, **k):
            return super().evaluate(*a, noise_provider=_provider(), **k)

    monkeypatch.setattr(jrender, "Evaluator", Injected)
    jrender.run_render(jargs, jdata, jd, params, jax.random.PRNGKey(0))
    got = trender.run_render(targs, tdata, td, noise_provider=_provider())
    want = np.load(tmp_path / "j.npy")
    Ftot = tdata.keypoints["S9"]["Act0 1"][0].shape[0]
    assert np.array_equal(np.load(tmp_path / "t.npy"), got)
    assert got.shape == want.shape == (Ftot, 17, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)

    gen = tgen.UnchunkedGenerator([tdata.cameras["S9"][0]["intrinsic"]],
                                  [tdata.poses_3d["S9"]["Act0 1"][0]],
                                  [tdata.keypoints["S9"]["Act0 1"][0]])
    preds = Evaluator(td, receptive_field=F, batch_size=2, kps_left=tdata.kps_left,
                      kps_right=tdata.kps_right).evaluate(
        gen, noise_provider=_provider(), return_predictions=True)
    assert np.array_equal(stitch_windows(preds[:, -1, 0], Ftot), got)


@pytest.mark.parametrize("fmt", ["gif", "mp4"])
def test_render_command_line_exports_and_animates(tmp_path, monkeypatch, fmt):
    """The H36M command line takes --render: the export, and the animation
    in the world frame beside the ground truth (mp4 through cv2 where no
    ffmpeg is installed)."""
    if fmt == "mp4":
        pytest.importorskip("cv2")
    monkeypatch.chdir(tmp_path)
    out = tmain.main(SMALL + RENDER + ["-b", "4", "--viz-export", "x.npy", "--viz-output",
                                       f"anim.{fmt}", "--viz-limit", "3", "--viz-size", "2"])
    export = np.load(tmp_path / "x.npy")
    assert export.shape == out.shape == (40, 17, 3) and np.isfinite(out).all()
    assert not np.array_equal(export, out)  # the animation's poses are in the world frame
    assert (tmp_path / f"anim.{fmt}").stat().st_size > 1000


def _skeleton():
    from d3dp_tpu_torch.data.h36m import H36M_JOINTS_REMOVED, h36m_skeleton

    sk = h36m_skeleton()
    sk.remove_joints(H36M_JOINTS_REMOVED)
    return sk


def _pixels_equal(dir_a, dir_b):
    files = sorted(os.path.relpath(os.path.join(r, f), dir_a)
                   for r, _, fs in os.walk(dir_a) for f in fs)
    want = sorted(os.path.relpath(os.path.join(r, f), dir_b)
                  for r, _, fs in os.walk(dir_b) for f in fs)
    assert files == want and files
    for f in files:
        assert np.array_equal(mpimg.imread(os.path.join(dir_a, f)),
                              mpimg.imread(os.path.join(dir_b, f))), f
    return files


@pytest.mark.parametrize("fn", ["draw_3d_image", "draw_3d_image_select", "draw_3d_image_azim",
                                "draw_3d_image_azim_ind"])
def test_plots_equal_jax(tmp_path, rng, fn):
    """Each plot function writes the same files with the same pixels as the
    JAX package's."""
    T = 2
    pred = (rng.randn(3, 2, T, 17, 3) * 0.3).astype(np.float32)
    gt = (rng.randn(T, 17, 3) * 0.3).astype(np.float32)
    args = (pred, gt, _skeleton(), 70.0, "S9", "Walk", 0)
    kw = {"draw_3d_image_select": lambda: dict(gt_2d=rng.randn(T, 17, 2),
                                               pred_2d=rng.randn(3, 2, T, 17, 2)),
          "draw_3d_image_azim": lambda: dict(azim_off=10, frame_stride=2),
          "draw_3d_image_azim_ind": lambda: dict(
              azim_off=5, select_ind=rng.randint(0, 2, (3, 1, T, 17)),
              min_ind=rng.randint(0, 2, (3, T, 17)), frame_stride=2, timestep_stride=2),
          "draw_3d_image": lambda: {}}[fn]()
    getattr(tviz, fn)(*args, out_dir=str(tmp_path / "t"), **kw)
    getattr(jviz, fn)(*args, out_dir=str(tmp_path / "j"), **kw)
    files = _pixels_equal(str(tmp_path / "t"), str(tmp_path / "j"))
    assert len(files) == {"draw_3d_image": T, "draw_3d_image_select": T,
                          "draw_3d_image_azim": 1, "draw_3d_image_azim_ind": 2}[fn]


@pytest.mark.parametrize("fmt", ["gif", "mp4"])
def test_render_animation_writes_gif_and_mp4(tmp_path, rng, fmt):
    """gif through pillow where imagemagick is missing, mp4 through the
    cv2.VideoWriter fallback where ffmpeg is missing: `limit` frames."""
    T = 6
    keypoints = rng.rand(T, 17, 2).astype(np.float32) * 200
    poses = {"Reconstruction": rng.randn(T, 17, 3).astype(np.float32) * 0.3}
    out = str(tmp_path / f"anim.{fmt}")
    if fmt == "mp4":
        cv2 = pytest.importorskip("cv2")
        _grey_video(tmp_path / "in.mp4", frames=T, size=(200, 200))
    tviz.render_animation(keypoints, {"keypoints_symmetry": ([4, 5, 6], [1, 2, 3])}, poses,
                          _skeleton(), fps=5, bitrate=1000, azim=70.0, output=out,
                          viewport=(200, 200), limit=4, size=2,
                          input_video_path=str(tmp_path / "in.mp4") if fmt == "mp4" else None)
    assert os.path.getsize(out) > 1000
    if fmt == "mp4":
        cap = cv2.VideoCapture(out)
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
        assert n == 4
    with pytest.raises(ValueError, match="Unsupported"):
        tviz.render_animation(keypoints, {}, poses, _skeleton(), 5, 1000, 70.0,
                              str(tmp_path / "anim.avi"), viewport=(200, 200), limit=2)


def test_video_io_matches_jax(tmp_path, rng):
    """read_video, get_resolution and get_fps (cv2 where ffmpeg is missing)
    and downsample_tensor as the JAX package's."""
    _grey_video(tmp_path / "v.mp4", frames=7, size=(32, 24))
    path = str(tmp_path / "v.mp4")
    assert tviz.get_resolution(path) == jviz.get_resolution(path) == (32, 24)
    assert tviz.get_fps(path) == jviz.get_fps(path)
    for kw in (dict(), dict(skip=2), dict(limit=3)):
        got, want = list(tviz.read_video(path, **kw)), list(jviz.read_video(path, **kw))
        assert len(got) == len(want) > 0
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    x = rng.randn(11, 17, 3)
    assert np.array_equal(tviz.downsample_tensor(x, 3), jviz.downsample_tensor(x, 3))


def test_collect_predictions_matches_jax(rng):
    """main_draw's hypothesis collector: the keypoint-symmetry flip, 12
    windows at 4 a call, the stitching of every (K, H) hypothesis."""
    jd, params, td, _ = _pair(joints_left=tuple(jsyn.JOINTS_LEFT),
                              joints_right=tuple(jsyn.JOINTS_RIGHT))
    _, _, p2 = jsyn.make_dataset(seed=2, lengths=(100,))
    seq_2d = np.asarray(p2[0], np.float32)
    key = jax.random.PRNGKey(9)
    want = jdraw.collect_predictions(JaxKeyNoise(jd), params, seq_2d, LR["kps_left"],
                                     LR["kps_right"], F, 4, key)
    got = tdraw.collect_predictions(TorchKeyNoise(td, key), seq_2d, LR["kps_left"],
                                    LR["kps_right"], F, 4, None)
    assert got.shape == want.shape == (K, H, 100, 17, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_main_draw_end_to_end(tmp_path, monkeypatch):
    """main_draw on the synthetic data with weights from --seed: root-zeroed
    hypotheses, their reprojections, and one plot per frame up to
    --viz-limit, named as the JAX package's."""
    monkeypatch.chdir(tmp_path)
    h = tdraw.main(SMALL + ["-b", "36", "--viz-limit", "2"])
    assert h["preds"].shape == (K, H, 40, 17, 3) and h["pred_2d"].shape == (K, H, 40, 17, 2)
    assert np.isfinite(h["pred_2d"]).all() and not h["preds"][..., 0, :].any()
    assert (h["subject"], h["action"], h["camera"]) == ("S9", "Act0 1", 0)
    assert sorted(os.listdir(tmp_path / "plot" / "synthetic" / "S9_Act0_1_0")) == \
        ["frame_0000.png", "frame_0001.png"]
    # the weights come from --seed: a second run draws the same hypotheses
    again = tdraw.hypotheses(tparse(SMALL + ["-b", "36"]))
    assert np.array_equal(again["preds"], h["preds"])

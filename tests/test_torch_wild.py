"""The port's in-the-wild path against the JAX package's, on the CPU, fed the
same numpy inputs and weights: the window sampler, the video-keypoint
sampler with its COCO flip and stitching, the world-frame post-process,
the whole pipeline from keypoints to its two .npy exports, and the
in-the-wild command line.

Sampling noise: `JaxKeyNoise` wraps the JAX D3DP so that each sampling call
draws its noise from the key `sample_windows` hands it; `TorchKeyNoise`
replays the same key chain for the port's D3DP, so both samplers see the
same draws micro-batch by micro-batch, pad rows included.

Tolerances: sampled predictions 5e-4 (the DDIM-replay bound of
tests/test_torch_model.py); the world frame 1e-5 (one fp32 quaternion
rotation of metre-scale poses).
"""

import os

import jax
import numpy as np
import pytest
import torch

from d3dp_tpu.cli.arguments import parse_args as jparse
from d3dp_tpu.data import windowing as jwin
from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.geometry.camera import camera_to_world as jcamera_to_world
from d3dp_tpu.in_the_wild import inference as jinf
from d3dp_tpu.models import MixSTEConfig as JMixSTEConfig
from d3dp_tpu_torch.cli import main_in_the_wild
from d3dp_tpu_torch.cli.arguments import parse_args as tparse
from d3dp_tpu_torch.data import windowing as twin
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.in_the_wild import inference as tinf
from d3dp_tpu_torch.in_the_wild import inference_video
from d3dp_tpu_torch.models import MixSTEConfig
from d3dp_tpu_torch.train.checkpoint_io import save_checkpoint
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from tests.test_torch_model import port_model, random_params

torch.set_num_threads(1)

F, H, K = 9, 2, 2
CFG = dict(num_frames=F, num_joints=17, embed_dim=64, depth=2, num_heads=8)
COCO = dict(joints_left=tuple(jinf.JOINTS_LEFT), joints_right=tuple(jinf.JOINTS_RIGHT))
WILD = ["-f", str(F), "-cs", "64", "-dep", "2", "-num_proposals", str(H),
        "-sampling_timesteps", str(K), "--viz-limit", "1"]
TOL = 5e-4


def _key_noise(key, B, Fr, cfg):
    """(img0, step_noises) of one sampling call, drawn from `key`."""
    k0, k1 = jax.random.split(key)
    shape = (B, cfg.num_proposals, Fr, 17, 3)
    return (jax.random.normal(k0, shape),
            jax.random.normal(k1, (cfg.sampling_timesteps,) + shape))


class JaxKeyNoise:
    """A JAX D3DP whose sampling noise is a function of the call's key."""

    def __init__(self, d3dp):
        self.d3dp = d3dp

    def sample(self, params, key, a, b):
        return self.d3dp.sample(params, key, a, b,
                                noise_override=_key_noise(key, a.shape[0], a.shape[1],
                                                          self.d3dp.cfg))


class TorchKeyNoise:
    """The port's D3DP fed JAX's draws: it splits `key` as sample_windows
    does, once per micro-batch."""

    def __init__(self, d3dp, key):
        self.d3dp, self.key, self.device = d3dp, key, d3dp.device
        self.calls = 0

    def sample(self, a, b, generator=None):
        self.key, sub = jax.random.split(self.key)
        self.calls += 1
        noise = tuple(np.array(x) for x in _key_noise(sub, a.shape[0], a.shape[1],
                                                         self.d3dp.cfg))
        return self.d3dp.sample(a, b, noise_override=noise)


def _pair(seed=3, **kw):
    """(JAX D3DP, its params, the port's D3DP) with the same weights."""
    jcfg = JMixSTEConfig(**CFG)
    params = random_params(jcfg, seed=seed, scale=0.02)
    dkw = dict(num_proposals=H, sampling_timesteps=K, **kw)
    jd = JD3DP(JD3DPConfig(model=jcfg, **dkw))
    td = D3DP(D3DPConfig(model=MixSTEConfig(**CFG), **dkw), model=port_model(params, **CFG))
    return jd, {"params": params}, td, params


def test_sample_windows_matches_jax(rng):
    """W=7 windows at bs=3: three calls, the last padded by two rows."""
    jd, params, td, _ = _pair(**COCO)
    w2d = (rng.randn(7, F, 17, 2) * 0.3).astype(np.float32)
    w2d_f = (rng.randn(7, F, 17, 2) * 0.3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = jwin.sample_windows(JaxKeyNoise(jd), params, w2d, w2d_f, 3, key)
    tnoise = TorchKeyNoise(td, key)
    got = twin.sample_windows(tnoise, w2d, w2d_f, 3, None)
    assert tnoise.calls == 3
    assert got.shape == want.shape == (7, K, H, F, 17, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_sample_windows_draws_from_the_generator_in_order():
    """Two calls from one seeded generator give the same stack; the second
    micro-batch draws after the first, so its windows differ from the first's
    even when the inputs are equal."""
    td = D3DP(D3DPConfig(model=MixSTEConfig(**CFG), num_proposals=H, sampling_timesteps=K),
              device="cpu", seed=1)
    w2d = np.zeros((4, F, 17, 2), np.float32)
    a = twin.sample_windows(td, w2d, w2d, 2, torch.Generator().manual_seed(0))
    b = twin.sample_windows(td, w2d, w2d, 2, torch.Generator().manual_seed(0))
    assert np.array_equal(a, b)
    assert not np.allclose(a[:2], a[2:])


@pytest.mark.parametrize("frames,bs", [(30, 3), (5, 4)])
def test_sample_video_keypoints_matches_jax(rng, frames, bs):
    """The COCO flip, the windows (30 frames: 4 windows, the last
    right-aligned; 5 frames: one edge-padded window) and the stitching."""
    jd, params, td, _ = _pair(**COCO)
    kps = (rng.rand(frames, 17, 2) * 2 - 1).astype(np.float32)
    key = jax.random.PRNGKey(2)
    want = jinf.sample_video_keypoints(JaxKeyNoise(jd), params, kps, F, bs, key)
    got = tinf.sample_video_keypoints(TorchKeyNoise(td, key), kps, F, bs, None)
    assert got.shape == want.shape == (K, H, frames, 17, 3)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_world_frame_matches_jax(rng):
    pred = (rng.randn(K, H, 30, 17, 3) * 0.5).astype(np.float32)
    got = tinf.world_frame(pred)
    want = np.array(jcamera_to_world(pred, jinf.H36M_ROT, np.zeros(3, np.float32)))
    want[..., 2] -= want[..., 2].min()
    assert got.shape == pred.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[..., 2].min() == 0.0
    assert np.array_equal(tinf.H36M_ROT, jinf.H36M_ROT)
    assert tinf.COCO_METADATA == jinf.COCO_METADATA
    assert (tinf.JOINTS_LEFT, tinf.JOINTS_RIGHT) == (jinf.JOINTS_LEFT, jinf.JOINTS_RIGHT)


def _reference_checkpoint(path, params):
    """The reference's .bin layout (DataParallel and wrapper prefixes), which
    both packages' load_any read; the JAX package maps it through
    torch_mixste_to_flax."""
    sd = state_dict_from_flax(params, CFG["depth"])
    torch.save({"model_pos": {f"module.pose_estimator.{k}": v for k, v in sd.items()},
                "epoch": 1, "lr": 1e-4}, path)


def _grey_video(path, frames=30, size=(64, 48)):
    cv2 = pytest.importorskip("cv2")
    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25, size)
    for _ in range(frames):
        vw.write(np.full((size[1], size[0], 3), 128, np.uint8))
    vw.release()


def test_pipeline_matches_jax_main(tmp_path, rng, monkeypatch):
    """JAX's in-the-wild `main` and the port's on one npz track of a 64x48
    video and one checkpoint, under the same draws: both .npy exports."""
    _grey_video(tmp_path / "vid.mp4")
    np.savez(tmp_path / "vid.npz", kpts=(rng.rand(30, 17, 2) * 40).astype(np.float32))
    _, _, _, params = _pair(seed=6)
    ckpt = str(tmp_path / "wild.bin")
    _reference_checkpoint(ckpt, params)
    seed = 4
    argv = WILD + ["-b", str(3 * F), "--platform", "cpu", "--seed", str(seed)]

    def setup(args):
        args.detector_2d, args.video_name, args.render_frames = "npz", "vid", False
        args.viz_video, args.evaluate = str(tmp_path / "vid.mp4"), ckpt
        return args

    real_j, real_t = jwin.sample_windows, tinf.sample_windows
    monkeypatch.setattr(jwin, "sample_windows", lambda d3dp, *a, **k: real_j(
        JaxKeyNoise(d3dp), *a, **k))
    monkeypatch.setattr(tinf, "sample_windows", lambda d3dp, *a: real_t(
        TorchKeyNoise(d3dp, jax.random.PRNGKey(seed)), *a))
    out = {}
    for name, run, args in (("jax", jinf.main, setup(jparse(argv + ["--dp", "1"],
                                                             in_the_wild=True))),
                            ("torch", tinf.main, setup(tparse(argv, in_the_wild=True)))):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        world = run(args)
        base = tmp_path / name / "outputs" / "vid"
        out[name] = (np.load(base / "test_3d_vid_output.npy"),
                     np.load(base / "test_3d_output_vid_postprocess.npy"), world)
    for got, want in zip(out["torch"], out["jax"]):
        assert got.shape == want.shape == (K, H, 30, 17, 3)
        np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert np.array_equal(out["torch"][1], out["torch"][2])
    assert out["torch"][1][..., 2].min() == 0.0


def test_inference_video_end_to_end(tmp_path, rng, monkeypatch):
    """A 30-frame 64x48 mp4 with its npz and a checkpoint the port wrote:
    (2, 2, 30, 17, 3) height-rebased, both exports, one plotted frame."""
    monkeypatch.chdir(tmp_path)
    _grey_video(tmp_path / "vid.mp4")
    np.savez(tmp_path / "vid.npz", kpts=(rng.rand(30, 17, 2) * 40).astype(np.float32))
    _, _, td, _ = _pair()
    save_checkpoint(str(tmp_path / "wild.ckpt"), epoch=1, lr=1e-4, model=td.model)
    out = inference_video(str(tmp_path / "vid.mp4"), "npz", checkpoint=str(tmp_path / "wild.ckpt"),
                          argv=WILD + ["-b", "36", "--platform", "cpu"])
    assert out.shape == (2, 2, 30, 17, 3) and np.isfinite(out).all()
    assert out[..., 2].min() == 0.0
    base = tmp_path / "outputs" / "vid"
    cam = np.load(base / "test_3d_vid_output.npy")
    assert cam.shape == out.shape and np.array_equal(np.load(
        base / "test_3d_output_vid_postprocess.npy"), out)
    np.testing.assert_allclose(tinf.world_frame(cam), out, atol=0, rtol=0)
    assert sorted(os.listdir(base / "vid_wild_0")) == ["frame_0000.png"]


def test_video_helpers_match_jax(tmp_path):
    """Frame size and splitting (cv2) as the JAX package's."""
    _grey_video(tmp_path / "long.mp4", frames=25, size=(40, 32))
    assert tinf.video_frame_size(str(tmp_path / "long.mp4")) == \
        jinf.video_frame_size(str(tmp_path / "long.mp4")) == (40, 32)
    got = tinf.split_video(str(tmp_path / "long.mp4"), 10, out_dir=str(tmp_path / "t"))
    want = jinf.split_video(str(tmp_path / "long.mp4"), 10, out_dir=str(tmp_path / "t"))
    assert got == want and [os.path.basename(p) for p in got] == \
        ["long_part000.mp4", "long_part001.mp4", "long_part002.mp4"]


def test_detectors():
    """The npz loader reads `kpts` beside the video; an unknown name raises
    (JAX asserts); the external detectors import lazily."""
    assert callable(tinf.get_detector_2d("npz"))
    with pytest.raises(ValueError, match="not implemented"):
        tinf.get_detector_2d("nonexistent_pose")
    with pytest.raises(ImportError):
        tinf.get_detector_2d("alpha_pose")


@pytest.mark.parametrize("argv", [
    [],
    ["-d", "synthetic", "-e", "3", "-b", "108", "-num_proposals", "5", "--fuse-level", "5"],
    ["--render", "--viz-subject", "S9", "--viz-action", "Act0 1", "--viz-export", "x.npy"],
])
def test_in_the_wild_flags_match_jax(argv):
    """parse_args(in_the_wild=True): the same namespace, stride 1, 120
    epochs, lr 4e-5, lrd 0.99, and -num_proposals 300 (the JAX parser's
    default)."""
    got = tparse(argv, in_the_wild=True)
    assert vars(got) == vars(jparse(argv, in_the_wild=True))
    if not argv:
        assert (got.stride, got.epochs, got.learning_rate, got.lr_decay, got.num_proposals) == \
            (1, 120, 4e-5, 0.99, 300)


def test_main_in_the_wild_trains_and_evaluates_with_p2(tmp_path):
    """The in-the-wild command line on the synthetic data: a --debug epoch,
    then --evaluate with Protocol-2 reported without --p2."""
    base = ["-d", "synthetic", "--nolog", "-f", "27", "-cs", "64", "-dep", "2", "-s", "27",
            "--synthetic-frames", "150", "--platform", "cpu", "--eval-batch-size", "4",
            "-c", str(tmp_path)]
    main_in_the_wild.main(base + ["-b", "108", "-e", "1", "-cf", "1", "--debug"])
    assert (tmp_path / "best_epoch.ckpt").exists()
    results = main_in_the_wild.main(base + ["--evaluate", "best_epoch.ckpt", "-num_proposals",
                                            "2", "-sampling_timesteps", "2"])
    assert list(results) == ["Act0", "Act1", "Act2"]
    for r in results.values():
        p2 = r.averages_p2_mm()
        assert set(p2) == {"J_Best", "P_Best", "P_Agg", "J_Agg"}
        assert all(np.isfinite(v).all() and v.shape == (2,) for v in p2.values())
    lines = open(tmp_path / "h36m_test_log_H2_K2.txt").read()
    assert "Protocol #2   (MPJPE) action-wise average" in lines

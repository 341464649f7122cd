"""The port's MPI-INF-3DHP path and its device Protocol-2 against the JAX
package's, on the CPU, fed the same numpy inputs.

Tolerances:
  * Procrustes alignment (batched SVD, fp32): 1e-5 of the largest value;
    LAPACK through torch and through XLA land within 6e-7 of it here.
  * Elementwise metrics, windowing, selections, the camera helpers and the
    synthetic data: 1e-6, most of them bit for bit (selections are gathers).
  * Evaluator P2 on the device: P1 within 3.1e-4 mm (the whole-pipeline
    bound), P2 at rtol 2e-3 / atol 5e-3 mm (tests/test_eval.py's bound for
    the device SVD against host LAPACK).
  * The whole 3DHP evaluation: .mat exports within 0.05 mm elementwise and
    log cells within 1e-3 mm (tests/test_pipeline_parity_3dhp.py's bounds).
  * PCK/AUC: plain numpy copies, so equal summaries and byte-equal CSVs.
"""

import importlib
import re

import jax
import numpy as np
import pytest
import scipy.io as sio
import torch

from d3dp_tpu.cli import main_3dhp as jmain
from d3dp_tpu.cli.arguments import parse_args as jparse
from d3dp_tpu.data import generators as jgen
from d3dp_tpu.data import mpi3dhp as jdata
from d3dp_tpu.data import synthetic as jsyn
from d3dp_tpu.data import windowing as jwin
from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.eval import Evaluator as JEvaluator
from d3dp_tpu.eval import aggregation as jagg
from d3dp_tpu.metrics import pck_auc as jpck
from d3dp_tpu.metrics import procrustes as jp2
from d3dp_tpu.models import MixSTEConfig as JMixSTEConfig
from d3dp_tpu_torch.cli import main_3dhp as tmain
from d3dp_tpu_torch.cli.arguments import parse_args as tparse
from d3dp_tpu_torch.data import generators as tgen
from d3dp_tpu_torch.data import mpi3dhp as tdata
from d3dp_tpu_torch.data import windowing as twin
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.eval import MODES, Evaluator
from d3dp_tpu_torch.eval import aggregation as tagg
from d3dp_tpu_torch.eval.evaluator_3dhp import MODES as MODES_3DHP
from d3dp_tpu_torch.metrics import pck_auc as tpck
from d3dp_tpu_torch.metrics import procrustes as tp2
from d3dp_tpu_torch.models import MixSTEConfig
from d3dp_tpu_torch.train.checkpoint_io import latest_checkpoint, load_any
from d3dp_tpu_torch.train.convert import state_dict_from_flax
from tests.test_torch_cli import _strip_numbers
from tests.test_torch_model import port_model, random_params

# the packages re-export a function named `mpjpe`, which shadows the module
jmet = importlib.import_module("d3dp_tpu.metrics.mpjpe")
tmet = importlib.import_module("d3dp_tpu_torch.metrics.mpjpe")

torch.set_num_threads(1)

T = torch.from_numpy


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ Procrustes
def _poses(rng, M):
    """M random (17, 3) pose pairs; the first target is the prediction
    mirrored in x (a reflection), scaled and shifted."""
    p = rng.randn(M, 17, 3).astype(np.float32)
    t = rng.randn(M, 17, 3).astype(np.float32)
    t[0] = p[0] * np.array([-1, 1, 1], np.float32) * 1.3 + 0.2
    return p, t


def _rel_close(got, want, rel=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), np.abs(got - want).max()


@pytest.mark.parametrize("M", [1, 7, 300])
def test_procrustes_align_and_p_mpjpe_match_jax(rng, M):
    p, t = _poses(rng, M)
    _rel_close(tp2.procrustes_align(T(p), T(t)), jp2.procrustes_align(p, t))
    _rel_close(tp2.p_mpjpe(T(p), T(t)), jp2.p_mpjpe(p, t))
    # the reflected pair aligns to a proper rotation: what is left is the
    # pose's own mirror asymmetry, not zero
    aligned = tp2.procrustes_align(T(p[:1]), T(t[:1]))
    assert float(tp2.p_mpjpe(aligned, T(t[:1]))) > 1e-3


@pytest.mark.parametrize("weights", [None, [1.0, 0.0, 1.0]])
@pytest.mark.parametrize("fn", ["p_mpjpe_diffusion", "p_mpjpe_diffusion_all_min",
                                "p_mpjpe_diffusion_reproj"])
def test_p_mpjpe_diffusion_family_matches_jax(rng, fn, weights):
    B, K, H, F, J = 3, 2, 4, 6, 17
    preds = rng.randn(B, K, H, F, J, 3).astype(np.float32)
    target = rng.randn(B, F, J, 3).astype(np.float32)
    preds[0, 0, 0, 0] = target[0, 0] * np.array([1, -1, 1], np.float32)  # a reflection
    w = None if weights is None else np.asarray(weights, np.float32)
    tw = None if w is None else T(w)
    if fn == "p_mpjpe_diffusion_reproj":
        reproj = rng.randn(B, K, H, F, J, 2).astype(np.float32)
        t2d = rng.randn(B, F, J, 2).astype(np.float32)
        cases = [((T(preds), T(target), T(reproj), T(t2d)), (preds, target, reproj, t2d), {})]
    else:
        cases = [((T(preds), T(target)), (preds, target), dict(mean_pos=mp))
                 for mp in (False, True)]
    for targs, jargs, kw in cases:
        got = getattr(tp2, fn)(*targs, weights=tw, **kw)
        want = getattr(jp2, fn)(*jargs, weights=w, **kw)
        assert got.shape == (K,)
        _rel_close(got, want)


# ------------------------------------------------------- the Evaluator's P2
F, H, K = 27, 2, 2
CFG = dict(num_frames=F, num_joints=17, embed_dim=64, depth=2, num_heads=8)
LR = dict(kps_left=list(jsyn.JOINTS_LEFT), kps_right=list(jsyn.JOINTS_RIGHT))


def _provider(seed=11):
    rng = np.random.RandomState(seed)

    def provider(n):
        img0 = rng.randn(4, H, F, 17, 3).astype(np.float32)
        steps = rng.randn(K, 4, H, F, 17, 3).astype(np.float32)
        return img0[:n].copy(), steps[:, :n].copy()
    return provider


def test_evaluator_p2_device_matches_host_and_jax():
    """100 + 80 frames at F=27: 4 + 3 windows, the second micro-batch padded
    to 4 with weight 0 (as tests/test_eval.py:114). Device P2 against the
    port's host P2 and against JAX's device P2, with the same weights and
    injected noise."""
    jcfg = JMixSTEConfig(**CFG)
    params = random_params(jcfg, seed=4, scale=0.02)
    dkw = dict(num_proposals=H, sampling_timesteps=K, joints_left=tuple(jsyn.JOINTS_LEFT),
               joints_right=tuple(jsyn.JOINTS_RIGHT))
    data = jsyn.make_dataset(seed=1, lengths=(100, 80))
    ekw = dict(receptive_field=F, batch_size=4, **LR)
    gen_lr = dict(LR, joints_left=list(jsyn.JOINTS_LEFT), joints_right=list(jsyn.JOINTS_RIGHT))

    jev = JEvaluator(JD3DP(JD3DPConfig(model=jcfg, **dkw)), p2_device=True, **ekw)
    want = jev.evaluate({"params": params}, jgen.UnchunkedGenerator(*data, **gen_lr),
                        jax.random.PRNGKey(0), noise_provider=_provider())
    td = D3DP(D3DPConfig(model=MixSTEConfig(**CFG), **dkw), model=port_model(params, **CFG))
    dev = Evaluator(td, p2_device=True, **ekw)
    assert dev.p2 and dev.p2_device
    got = dev.evaluate(tgen.UnchunkedGenerator(*data), noise_provider=_provider())
    host = Evaluator(td, p2=True, **ekw).evaluate(tgen.UnchunkedGenerator(*data),
                                                   noise_provider=_provider())
    # the device P2 vectors are deferred, as P1's are: tensors until read
    assert all(isinstance(v, torch.Tensor) for e, _ in got.pending_p2 for v in e.values())

    assert got.n == host.n == want.n == (4 + 3) * F
    g1, h1, w1 = got.averages_mm(), host.averages_mm(), want.averages_mm()
    g2, h2, w2 = got.averages_p2_mm(), host.averages_p2_mm(), want.averages_p2_mm()
    assert set(g2) == set(h2) == set(w2) == set(MODES)
    for m in MODES:
        assert np.array_equal(g1[m], h1[m])
        np.testing.assert_allclose(g1[m], w1[m], atol=3.1e-4, rtol=0, err_msg=m)
        assert g2[m].shape == (K,) and np.isfinite(g2[m]).all()
        for other in (h2, w2):
            np.testing.assert_allclose(g2[m], other[m], rtol=2e-3, atol=5e-3, err_msg=m)


def test_light_evaluator_takes_no_device_p2():
    td = D3DP(D3DPConfig(model=MixSTEConfig(**CFG)), device="cpu")
    with pytest.raises(ValueError, match="no p2"):
        Evaluator(td, light=True, p2_device=True)


# ------------------------------------------------------------- small pieces
def _close(got, want, atol=1e-6):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_mpjpe_3dhp_and_the_other_losses_match_jax(rng):
    B, Kk, Hh, Ff, J = 3, 2, 4, 9, 17
    preds = rng.randn(B, Kk, Hh, Ff, J, 3).astype(np.float32)
    target = rng.randn(B, Ff, J, 3).astype(np.float32)
    valid = (rng.rand(B, Ff) > 0.3).astype(np.float32)
    valid[-1] = 0.0  # a padded window
    for mp in (False, True):
        _close(tmet.mpjpe_diffusion_3dhp(T(preds), T(target), T(valid), mean_pos=mp),
               jmet.mpjpe_diffusion_3dhp(preds, target, valid, mean_pos=mp))
    p, t = preds[:, 0, 0], target
    _close(tmet.n_mpjpe(T(p), T(t)), jmet.n_mpjpe(p, t))
    for axis in (0, 1):
        _close(tmet.mean_velocity_error_train(T(p), T(t), axis=axis),
               jmet.mean_velocity_error_train(p, t, axis=axis))
    _close(tmet.mean_velocity_error(T(p), T(t)), jmet.mean_velocity_error(p, t))
    (ga, gj), (wa, wj) = tmet.mpjpe(T(p), T(t), return_joints_err=True), \
        jmet.mpjpe(p, t, return_joints_err=True)
    _close(ga, wa)
    _close(gj, wj, atol=1e-3)  # per-joint errors in mm: 1e-6 in metres
    assert gj.shape == (J,)
    with pytest.raises(ValueError):
        tmet.n_mpjpe(T(p), T(t[:1]))


@pytest.mark.parametrize("total", [10, 27, 30, 54, 80])
def test_stitch_windows_and_window_batch_match_jax(rng, total):
    seq2d = rng.randn(total, 17, 2).astype(np.float32)
    seq3d = rng.randn(total, 17, 3).astype(np.float32)
    valid = (rng.rand(total) > 0.2).astype(np.float32)
    for with_valid in (False, True):
        v = valid if with_valid else None
        got, want = twin.window_batch(seq2d, seq3d, F, v), jwin.window_batch(seq2d, seq3d, F, v)
        assert len(got) == len(want) == (3 if with_valid else 2)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)
    windows = twin.window_sequence(seq3d, F)
    back = twin.stitch_windows(windows, total)
    assert np.array_equal(back, jwin.stitch_windows(windows, total))
    assert np.array_equal(back, seq3d)  # the right-aligned last window covers the tail


def test_unchunked_generator_yields_valid_and_key_as_jax(rng):
    p3 = [rng.randn(n, 17, 3).astype(np.float32) for n in (30, 12)]
    p2 = [rng.randn(n, 17, 2).astype(np.float32) for n in (30, 12)]
    valid = [np.ones(30, np.float32), np.zeros(12, np.float32)]
    for keys in (["TS1", "TS5"], None):
        got = list(tgen.UnchunkedGenerator(None, p3, p2, valid_frames=valid, keys=keys)
                   .next_epoch())
        want = list(jgen.UnchunkedGenerator(None, p3, p2, valid_frames=valid, keys=keys)
                    .next_epoch())
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert len(g) == len(w) == 5 and g[0] is None and w[0] is None
            for a, b in zip(g[1:4], w[1:4]):
                assert np.array_equal(a, b)
            assert g[4] == w[4]
    assert [len(x) for x in tgen.UnchunkedGenerator(None, p3, p2).next_epoch()] == [3, 3]
    with pytest.raises(ValueError):
        tgen.UnchunkedGenerator(None, p3, p2, valid_frames=valid[:1])


def _selection_stack(rng):
    """Integer-valued poses (exact float arithmetic) with hypothesis 1 the
    mirror of hypothesis 0 about the target and the others further away:
    equal least errors, other poses, so every argmin over H is a tie
    between 0 and 1."""
    B, Kk, Hh, Ff, J = 2, 3, 4, 5, 17
    target = rng.randint(-20, 20, (B, Ff, J, 3)).astype(np.float32)
    off = rng.choice([-1.0, 1.0], (B, Kk, 1, Ff, J, 3)).astype(np.float32)
    far = rng.randint(2, 5, (B, Kk, Hh - 2, Ff, J, 3)).astype(np.float32)
    preds = target[:, None, None] + np.concatenate([off, -off, far], axis=2)
    t2d = rng.randint(-20, 20, (B, Ff, J, 2)).astype(np.float32)
    off2 = off[..., :2]
    reproj = t2d[:, None, None] + np.concatenate([off2, -off2, far[..., :2]], axis=2)
    return preds, target, reproj, t2d


@pytest.mark.parametrize("ties", [False, True])
def test_selections_match_jax(rng, ties):
    if ties:
        preds, target, reproj, t2d = _selection_stack(rng)
    else:
        preds = rng.randn(2, 3, 4, 5, 17, 3).astype(np.float32)
        target = rng.randn(2, 5, 17, 3).astype(np.float32)
        reproj = rng.randn(2, 3, 4, 5, 17, 2).astype(np.float32)
        t2d = rng.randn(2, 5, 17, 2).astype(np.float32)
    w = np.array([1.0, 0.0], np.float32)
    cases = [
        (tagg.select_p_agg(T(preds)), jagg.select_p_agg(preds)),
        (tagg.select_p_best(T(preds), T(target)), jagg.select_p_best(preds, target)),
        (tagg.select_p_best(T(preds), T(target), weights=T(w)),
         jagg.select_p_best(preds, target, weights=w)),
        (tagg.select_j_best(T(preds), T(target)), jagg.select_j_best(preds, target)),
        (tagg.select_j_agg(T(preds), T(reproj), T(t2d)), jagg.select_j_agg(preds, reproj, t2d)),
    ]
    for got, want in cases:
        _close(got, want)
    if ties:  # the tie goes to the first hypothesis, the one above the target
        for got, _ in cases[1:]:
            assert torch.equal(got, T(preds[:, :, 0]))


def test_camera_helpers_match_jax():
    """As tests/test_3dhp.py:73-104, and equal to the JAX package's bit for
    bit."""
    for cam, cd in (tdata.CAM_TS1_4, tdata.CAM_TS5_6):
        got = tdata.cam_mm_to_pix(cam, cd)
        assert np.array_equal(got, jdata.cam_mm_to_pix(cam, cd))
        mx, my = cd[0] / cd[2], cd[1] / cd[3]
        assert got[0] == pytest.approx(cam[0] * mx) and got[1] == pytest.approx(cam[1] * my)
        assert got[2] == pytest.approx(cam[2] * mx + cd[0] / 2)
        assert got[3] == pytest.approx(cam[3] * my + cd[1] / 2)
    for key in ("TS1", "TS4", "TS5", "TS6"):
        (gc, gwh), (wc, wwh) = tdata.camera_for_sequence(key), jdata.camera_for_sequence(key)
        assert np.array_equal(gc, wc) and gwh == wwh
        assert tdata.uses_distortion_projection(key) == jdata.uses_distortion_projection(key)
    assert tdata.camera_for_sequence("TS1")[1] == (2048, 2048)
    assert tdata.camera_for_sequence("TS5")[1] == (1920, 1080)
    assert tdata.camera_for_sequence("TS1")[0][0] == pytest.approx(7.32506 * 204.8)
    assert tdata.camera_for_sequence("TS5")[0][1] == pytest.approx(8.770747185 * 192.0)
    assert (tdata.KPS_LEFT, tdata.KPS_RIGHT, tdata.ROOT_JOINT) == \
        (jdata.KPS_LEFT, jdata.KPS_RIGHT, jdata.ROOT_JOINT)


@pytest.mark.parametrize("seed,frames", [(0, 120), (3, 70)])
def test_make_synthetic_equals_jax(seed, frames):
    got, want = tdata.make_synthetic(seed, frames=frames), jdata.make_synthetic(seed, frames=frames)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


def test_npz_loaders_match_jax(rng, tmp_path):
    train = {"S1 Seq1": [{c: {"data_3d": rng.randn(20, 17, 3) * 100,
                              "data_2d": rng.rand(20, 17, 2) * 2000} for c in (0, 2)}]}
    test = {k: {"data_3d": rng.randn(15, 17, 3) * 100, "data_2d": rng.rand(15, 17, 2) * 1900,
                "valid": rng.rand(15) > 0.2} for k in ("TS1", "TS5")}
    np.savez(tmp_path / "train.npz", data=train)
    np.savez(tmp_path / "test.npz", data=test)
    for got, want in ((tdata.load_train(str(tmp_path / "train.npz")),
                       jdata.load_train(str(tmp_path / "train.npz"))),
                      (tdata.load_test(str(tmp_path / "test.npz")),
                       jdata.load_test(str(tmp_path / "test.npz")))):
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k
    for load in (tdata.load_train, tdata.load_test):
        with pytest.raises(FileNotFoundError, match="DATASETS.md"):
            load(str(tmp_path / "absent.npz"))


# -------------------------------------------------------------------- PCK/AUC
def test_pck_auc_matches_jax_on_the_known_offset_fixture(rng, tmp_path):
    """tests/test_3dhp.py:107's fixture: predictions a constant 40 mm from
    the root-centred GT on valid frames, through .mat files."""
    n_seq, Ftot, Kt, offset = 2, 30, 2, 40.0
    inference = {}
    for i in range(1, n_seq + 1):
        gt = rng.randn(3, 17, Ftot).astype(np.float64) * 100
        valid = np.ones(Ftot)
        valid[5:10] = 0
        acts = rng.randint(1, 8, Ftot)
        root_centred = gt - gt[:, 14:15, :]
        inference[f"TS{i}"] = np.stack(
            [root_centred + np.array([offset, 0, 0])[:, None, None] for _ in range(Kt)], axis=-1)
        (tmp_path / f"TS{i}").mkdir()
        sio.savemat(tmp_path / f"TS{i}" / "annot_data.mat",
                    {"annot3": gt, "valid_frame": valid, "activity_annotation": acts})
    sio.savemat(tmp_path / "inference.mat", inference)
    got = tpck.evaluate_3dhp_mat(str(tmp_path / "inference.mat"), str(tmp_path), "J_Best",
                                 str(tmp_path / "torch"), n_seq=n_seq)
    want = jpck.evaluate_3dhp_mat(str(tmp_path / "inference.mat"), str(tmp_path), "J_Best",
                                  str(tmp_path / "jax"), n_seq=n_seq)
    assert got == want and sorted(got) == [1, 2]
    for t in (1, 2):
        assert got[t]["mpjpe"] == pytest.approx(offset, abs=1e-9)
        assert got[t]["pck"] == pytest.approx(100.0)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == names and len(names) == 4
    for name in names:
        assert (tmp_path / "torch" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    assert (tpck.THRESHOLDS == jpck.THRESHOLDS).all() and tpck.JOINT_GROUPS == jpck.JOINT_GROUPS
    errors = rng.rand(17, 50) * 200
    g, w = tpck.compute_pck_auc(errors), jpck.compute_pck_auc(errors)
    assert all(np.array_equal(g[k], w[k]) for k in w)


# ---------------------------------------------------------- the whole slice
SMALL = ["-d", "synthetic", "--nolog", "-f", "27", "-cs", "64", "-dep", "2",
         "--synthetic-frames", "70", "--platform", "cpu", "--eval-batch-size", "2"]
H3, K3 = 3, 2


def _provider_3dhp(seed, n_h, n_k):
    rng = np.random.RandomState(seed)

    def provider(n):
        img0 = rng.randn(n, n_h, F, 17, 3).astype(np.float32)
        return img0, rng.randn(n_k, n, n_h, F, 17, 3).astype(np.float32)
    return provider


def _ts1_ts5(data):
    """make_synthetic's two test sequences as TS1 (the linear projection)
    and TS5 (the distortion projection, 1920 x 1080)."""
    p3_train, p2_train, p3, p2, valid = data
    rename = {"TS1": "TS1", "TS2": "TS5"}
    return (p3_train, p2_train, {rename[k]: v for k, v in p3.items()},
            {rename[k]: v for k, v in p2.items()}, {rename[k]: v for k, v in valid.items()})


_CELL = re.compile(r"^step (\d+) : Protocol #1 Error \(MPJPE\) (\w+): ([\d.]+) mm$")


def _cells(path):
    out = {}
    for line in open(path):
        m = _CELL.match(line.strip())
        if m:
            out[(int(m.group(1)), m.group(2))] = float(m.group(3))
    return out


@pytest.mark.parametrize("level", [2, 5])
def test_run_evaluation_matches_jax(tmp_path, monkeypatch, level):
    """main_3dhp.run_evaluation of both packages at `--fuse-level level` on
    synthetic data with TS1 and TS5: 70 frames are 3 windows of 27, so each
    sequence's second micro-batch of 2 is padded. Same weights and injected
    noise; the JAX model on its Pallas kernels (interpret mode)."""
    monkeypatch.chdir(tmp_path)  # no 3dhp_test/ here: the PCK stage is skipped
    argv = SMALL + ["--evaluate", "best_epoch.ckpt", "-num_proposals", str(H3),
                    "-sampling_timesteps", str(K3), "--fuse-level", str(level)]
    jargs, targs = jparse(argv + ["-c", "jax"]), tparse(argv + ["-c", "torch"])
    jd_data, td_data = _ts1_ts5(jmain._load_data(jargs)), _ts1_ts5(tmain._load_data(targs))
    jcfg = JMixSTEConfig(num_frames=F, embed_dim=64, depth=2, attention_impl="pallas",
                         fuse_level=level)
    params = random_params(jcfg, seed=4, scale=0.02)
    jd = JD3DP(JD3DPConfig(model=jcfg, num_proposals=H3, sampling_timesteps=K3,
                           joints_left=tuple(jdata.KPS_LEFT), joints_right=tuple(jdata.KPS_RIGHT),
                           unit_scale=1000.0))
    want = jmain.run_evaluation(jargs, jd_data, jd, {"params": params}, jax.random.PRNGKey(0),
                                noise_provider=_provider_3dhp(5, H3, K3))
    _, _, td = tmain._build_models(targs, "cpu")
    assert td.cfg.unit_scale == 1000.0 and td.cfg.joints_left == tuple(tdata.KPS_LEFT)
    td.model.load_state_dict(state_dict_from_flax(params, 2))
    got = tmain.run_evaluation(targs, td_data, td, noise_provider=_provider_3dhp(5, H3, K3))

    for m in ("P_Best", "P_Agg"):
        assert got[m].shape == (K3,) and np.isfinite(got[m]).all()
        np.testing.assert_allclose(got[m], want[m], atol=1e-3, rtol=0, err_msg=m)
    for mode in MODES_3DHP:
        g = sio.loadmat(tmp_path / "torch" / f"inference_data_{mode}.mat")
        w = sio.loadmat(tmp_path / "jax" / f"inference_data_{mode}.mat")
        for seq in ("TS1", "TS5"):
            assert g[seq].shape == w[seq].shape == (3, 17, 70, K3)
            assert np.abs(g[seq] - w[seq]).max() <= 0.05, (mode, seq)
    log = f"3dhp_test_log_H{H3}_K{K3}.txt"
    gc, wc = _cells(tmp_path / "torch" / log), _cells(tmp_path / "jax" / log)
    assert set(gc) == set(wc) and len(gc) == 2 * K3
    assert all(abs(gc[c] - wc[c]) <= 1e-3 for c in wc)
    lines = _strip_numbers(tmp_path / "torch" / log)
    assert lines == _strip_numbers(tmp_path / "jax" / log) and len(lines) == 2 * K3


def test_pck_stage_runs_when_the_annotations_are_present(tmp_path, monkeypatch, capsys):
    """run_evaluation's last stage: with 3dhp_test/TS*/annot_data.mat in the
    working directory it writes the CSV pair per mode and step."""
    monkeypatch.chdir(tmp_path)
    targs = tparse(SMALL + ["--evaluate", "x", "-num_proposals", "2", "-sampling_timesteps",
                            "2", "--fuse-level", "4", "-c", "out"])
    data = tmain._load_data(targs)
    rng = np.random.RandomState(0)
    for key, p3 in data[2].items():
        gt = p3.copy()
        gt[:, :14] += gt[:, 14:15]  # absolute: the root keeps the trajectory
        gt[:, 15:] += gt[:, 14:15]
        (tmp_path / "3dhp_test" / key).mkdir(parents=True)
        sio.savemat(tmp_path / "3dhp_test" / key / "annot_data.mat",
                    {"annot3": gt.transpose(2, 1, 0), "valid_frame": data[4][key],
                     "activity_annotation": rng.randint(1, 8, len(gt))})
    _, _, td = tmain._build_models(targs, "cpu")
    tmain.run_evaluation(targs, data, td)
    out = capsys.readouterr().out
    for mode in MODES_3DHP:
        assert re.search(rf"{mode}: MPJPE \d+\.\d+ mm, PCK \d+\.\d+, AUC \d+\.\d+ \(t2\)", out)
        for t in (1, 2):
            for kind in ("sequencewise", "activitywise"):
                assert (tmp_path / "out" /
                        f"mpii_3dhp_evaluation_{kind}_ori_{mode}_t{t}.csv").exists()


def test_debug_training_checkpoints_reload(tmp_path, monkeypatch):
    """One --debug epoch through main_3dhp writes epoch_1 and best_epoch;
    --resume restores weights, AdamW state, lr, epoch and the generator's
    random state; --evaluate samples with the trained weights and exports
    the four .mat files."""
    built, gens = [], []
    build_models = tmain._build_models

    def build(*a, **k):
        built.append(build_models(*a, **k))
        return built[-1]

    class Recording(tmain.ChunkedGenerator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            gens.append(self)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmain, "_build_models", build)
    monkeypatch.setattr(tmain, "ChunkedGenerator", Recording)
    argv = SMALL + ["-c", str(tmp_path / "ck"), "-b", "108", "-s", "27", "--debug"]
    opt = tmain.main(argv + ["-e", "1", "-cf", "1"])
    trained = {k: v.clone() for k, v in built[-1][0].model.state_dict().items()}
    saved_rs = gens[-1].random_state().get_state()
    for name in ("epoch_1.ckpt", "best_epoch.ckpt"):
        ck = load_any(str(tmp_path / "ck" / name))
        assert ck["epoch"] == 1 and ck["lr"] == pytest.approx(6e-5 * 0.993)
    assert latest_checkpoint(str(tmp_path / "ck")).endswith("epoch_1.ckpt")
    with open(tmp_path / "ck" / "training_log.txt") as f:
        line = f.read().splitlines()[-1]
    assert re.fullmatch(r"\[1\] time \S+ lr \S+ 3d_train \S+ 3d_pos_valid \S+", line)

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

    results = tmain.main(argv + ["--evaluate", "best_epoch.ckpt", "-num_proposals", "2",
                                 "-sampling_timesteps", "2", "--fuse-level", "1"])
    for k, v in built[-1][2].model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    assert all(np.isfinite(results[m]).all() and results[m].shape == (2,)
               for m in ("P_Best", "P_Agg"))
    for mode in MODES_3DHP:  # --debug evaluates one micro-batch: no sequence is covered
        assert (tmp_path / "ck" / f"inference_data_{mode}.mat").exists()

"""d3dp_tpu_torch geometry, metrics and host data helpers against the JAX
package, on the CPU, fed the same numpy inputs.

Geometry and Protocol-1 metrics are fp32 elementwise math and short sums,
so only op order separates the two: atol 1e-5 (geometry, values of order
1-10) and 1e-6 (metrics, errors of order 1). Protocol-2 and windowing are
copies of the same numpy code and must agree bit for bit.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3dp_tpu.data import windowing as jwin
from d3dp_tpu.geometry import camera as jcam
from d3dp_tpu.geometry import quaternion as jquat
from d3dp_tpu.metrics import procrustes_np as jp2
from d3dp_tpu_torch.data import windowing as twin
from d3dp_tpu_torch.data.prefetch import Prefetcher
from d3dp_tpu_torch.geometry import camera as tcam
from d3dp_tpu_torch.geometry import quaternion as tquat
from d3dp_tpu_torch.metrics import procrustes_np as tp2

# the packages re-export a function named `mpjpe`, which shadows the module
jmet = importlib.import_module("d3dp_tpu.metrics.mpjpe")
tmet = importlib.import_module("d3dp_tpu_torch.metrics.mpjpe")

torch.set_num_threads(1)


def _cam(rng, n):
    cam = np.concatenate([1 + rng.rand(n, 2), 0.1 * rng.randn(n, 2), 0.1 * rng.randn(n, 5)],
                         axis=1)
    return cam.astype(np.float32)


def _quat(rng, shape):
    q = rng.randn(*shape, 4)
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def _geometry_cases(rng):
    pts = rng.randn(3, 7, 17, 3).astype(np.float32)
    pts[..., 2] += 5.0  # in front of the camera
    cam = _cam(rng, 3)
    q, t = _quat(rng, ()), rng.randn(3).astype(np.float32)
    qs = _quat(rng, (3, 7, 17))
    uvd = rng.randn(3, 7, 17, 3).astype(np.float32)
    gt = pts.copy()
    px = (rng.rand(3, 17, 2) * 1000).astype(np.float32)
    return {
        "project_to_2d": ((pts, cam), jcam.project_to_2d, tcam.project_to_2d),
        "project_to_2d_linear": ((pts, cam), jcam.project_to_2d_linear,
                                 tcam.project_to_2d_linear),
        "world_to_camera": ((pts, q, t), jcam.world_to_camera, tcam.world_to_camera),
        "camera_to_world": ((pts, q, t), jcam.camera_to_world, tcam.camera_to_world),
        "qrot": ((qs, pts), jquat.qrot, tquat.qrot),
        "qinverse": ((qs,), jquat.qinverse, tquat.qinverse),
        "uvd2xyz": ((uvd, gt, cam), jcam.uvd2xyz, tcam.uvd2xyz),
        "normalize_screen_coordinates": ((px, 1000, 1002), jcam.normalize_screen_coordinates,
                                         tcam.normalize_screen_coordinates),
        "image_coordinates": ((px / 500 - 1, 1000, 1002), jcam.image_coordinates,
                              tcam.image_coordinates),
    }


GEOMETRY = ("project_to_2d", "project_to_2d_linear", "world_to_camera", "camera_to_world",
            "qrot", "qinverse", "uvd2xyz", "normalize_screen_coordinates", "image_coordinates")


@pytest.mark.parametrize("name", GEOMETRY)
def test_geometry_matches_jax(rng, name):
    args, jfn, tfn = _geometry_cases(rng)[name]
    want = np.asarray(jfn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                            for a in args]))
    got = tfn(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args])
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def _hypotheses(rng, B=3, K=2, H=4, F=5, J=17):
    pred = (0.2 * rng.randn(B, K, H, F, J, 3)).astype(np.float32)
    tgt = (0.2 * rng.randn(B, F, J, 3)).astype(np.float32)
    rep = rng.randn(B, K, H, F, J, 2).astype(np.float32)
    tgt2 = rng.randn(B, F, J, 2).astype(np.float32)
    w = np.array([1, 1, 0], np.float32)
    return pred, tgt, rep, tgt2, w


@pytest.mark.parametrize("weighted", [False, True])
def test_p1_metrics_match_jax(rng, weighted):
    pred, tgt, rep, tgt2, w = _hypotheses(rng)
    w = w if weighted else None
    j = [jnp.asarray(a) for a in (pred, tgt, rep, tgt2)]
    jw = None if w is None else jnp.asarray(w)
    t = [torch.from_numpy(a) for a in (pred, tgt, rep, tgt2)]
    tw = None if w is None else torch.from_numpy(w)
    pairs = [
        (jmet.mpjpe_diffusion(j[0], j[1], weights=jw),
         tmet.mpjpe_diffusion(t[0], t[1], weights=tw)),
        (jmet.mpjpe_diffusion(j[0], j[1], mean_pos=True, weights=jw),
         tmet.mpjpe_diffusion(t[0], t[1], mean_pos=True, weights=tw)),
        (jmet.mpjpe_diffusion_all_min(j[0], j[1], weights=jw),
         tmet.mpjpe_diffusion_all_min(t[0], t[1], weights=tw)),
        (jmet.mpjpe_diffusion_reproj(*j, weights=jw),
         tmet.mpjpe_diffusion_reproj(*t, weights=tw)),
        (jmet.mpjpe(j[0][:, 0, 0], j[1]), tmet.mpjpe(t[0][:, 0, 0], t[1])),
    ]
    for want, got in pairs:
        assert tuple(got.shape) == np.shape(want)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
    err2d = np.linalg.norm(rep - tgt2[:, None, None], axis=-1)
    assert np.array_equal(tmet.joint_select_by_reproj(torch.from_numpy(err2d)).numpy(),
                          np.asarray(jmet.joint_select_by_reproj(jnp.asarray(err2d))))


def test_p2_host_metrics_equal_jax(rng):
    pred, tgt, rep, tgt2, _ = _hypotheses(rng)
    pairs = [
        (jp2.p_mpjpe_diffusion_np(pred, tgt), tp2.p_mpjpe_diffusion_np(pred, tgt)),
        (jp2.p_mpjpe_diffusion_np(pred, tgt, mean_pos=True),
         tp2.p_mpjpe_diffusion_np(pred, tgt, mean_pos=True)),
        (jp2.p_mpjpe_diffusion_all_min_np(pred, tgt), tp2.p_mpjpe_diffusion_all_min_np(pred, tgt)),
        (jp2.p_mpjpe_diffusion_reproj_np(pred, tgt, rep, tgt2),
         tp2.p_mpjpe_diffusion_reproj_np(pred, tgt, rep, tgt2)),
        (jp2.p_mpjpe_np(pred[:, 0, 0].reshape(-1, 17, 3), tgt.reshape(-1, 17, 3)),
         tp2.p_mpjpe_np(pred[:, 0, 0].reshape(-1, 17, 3), tgt.reshape(-1, 17, 3))),
    ]
    for want, got in pairs:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("T", [5, 27, 60, 81])
def test_window_sequence_equals_jax(rng, T):
    seq = rng.randn(T, 17, 2).astype(np.float32)
    got, want = twin.window_sequence(seq, 27), jwin.window_sequence(seq, 27)
    assert got.shape == want.shape and np.array_equal(got, want)


def test_prefetcher_keeps_order_and_reraises():
    assert list(Prefetcher(iter(range(50)), depth=2)) == list(range(50))

    def failing():
        yield 1
        raise KeyError("boom")
    with pytest.raises(KeyError, match="boom"):
        list(Prefetcher(failing()))

"""MPI-INF-3DHP dataset: npz loaders, camera constants and synthetic data.

Counterpart of d3dp_tpu/data/mpi3dhp.py (reference: main_3dhp.py:110-160).
Train data is keyed (subject, seq, cam) from data_train_3dhp_ori.npz, test
data TS1..TS6 from data_test_3dhp_ori.npz with valid-frame masks. Poses are
in millimetres, root-centred at joint 14 (pelvis) keeping the root
trajectory; 2D is screen-normalised per camera resolution (TS5/TS6 are
1920x1080, the rest 2048x2048).

The camera constants are the published 3DHP calibration
(main_3dhp.py:697-704), with the mm -> pixel conversion `cam_mm_to_pix`
(main_3dhp.py:334-343).
"""

import os

import numpy as np

from d3dp_tpu_torch.data.synthetic import make_sequence
from d3dp_tpu_torch.geometry.camera import normalize_screen_coordinates

# 17-joint CPM-order symmetry (main_3dhp.py:117-118)
KPS_LEFT = [5, 6, 7, 11, 12, 13]
KPS_RIGHT = [2, 3, 4, 8, 9, 10]
ROOT_JOINT = 14  # pelvis

# intrinsics in mm: fx fy cx cy k1 k2 k3 p1 p2, and (width, height, ss_x, ss_y)
CAM_TS1_4 = (np.array([7.32506, 7.32506, -0.0322884, 0.0929296,
                       0, 0, 0, 0, 0], np.float32),
             [2048, 2048, 10, 10])
CAM_TS5_6 = (np.array([8.770747185, 8.770747185, -0.104908645, 0.104899704,
                       0, 0, 0, 0, 0], np.float32),
             [1920, 1080, 10, 5.625])


def cam_mm_to_pix(cam, cam_data):
    """mm-unit intrinsics to pixels. (main_3dhp.py:334-343)"""
    cam = np.array(cam, np.float32)
    w, h, ss_x, ss_y = cam_data
    mx, my = w / ss_x, h / ss_y
    cam[0] *= mx
    cam[1] *= my
    cam[2] = cam[2] * mx + w / 2
    cam[3] = cam[3] * my + h / 2
    return cam


def camera_for_sequence(key):
    """(pixel intrinsics (9,), (width, height)) of a test sequence."""
    cam, cd = CAM_TS5_6 if key in ("TS5", "TS6") else CAM_TS1_4
    return cam_mm_to_pix(cam, cd), (cd[0], cd[1])


def uses_distortion_projection(key):
    """TS5/TS6 take the distortion projection, TS1-4 the linear one
    (main_3dhp.py:806-813). With zero coefficients the two differ only in
    the distortion path's clamp of x/z to +-1, which matters at frame
    edges."""
    return key in ("TS5", "TS6")


def _root_center(data_3d):
    out = np.array(data_3d, np.float32)
    out[:, :ROOT_JOINT] -= out[:, ROOT_JOINT : ROOT_JOINT + 1]
    out[:, ROOT_JOINT + 1 :] -= out[:, ROOT_JOINT : ROOT_JOINT + 1]
    return out


def load_train(path="./data/data_train_3dhp_ori.npz"):
    """-> (poses_3d, poses_2d) dicts keyed (subject, seq, cam).
    (main_3dhp.py:122-136)"""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — see DATASETS.md for dataset setup, or use "
            "'-d synthetic' for a no-data smoke run")
    data_train = np.load(path, allow_pickle=True)["data"].item()
    poses_3d, poses_2d = {}, {}
    for seq in data_train.keys():
        for cam in data_train[seq][0].keys():
            anim = data_train[seq][0][cam]
            subject_name, seq_name = seq.split(" ")
            key = (subject_name, seq_name, cam)
            poses_3d[key] = _root_center(anim["data_3d"])
            data_2d = np.array(anim["data_2d"], np.float32)
            data_2d[..., :2] = normalize_screen_coordinates(data_2d[..., :2], w=2048, h=2048)
            poses_2d[key] = data_2d
    return poses_3d, poses_2d


def load_test(path="./data/data_test_3dhp_ori.npz"):
    """-> (poses_3d, poses_2d, valid_frame) dicts keyed TS1..TS6.
    (main_3dhp.py:139-160)"""
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path} not found — see DATASETS.md for dataset setup")
    data_test = np.load(path, allow_pickle=True)["data"].item()
    poses_3d, poses_2d, valid_frame = {}, {}, {}
    for seq in data_test.keys():
        anim = data_test[seq]
        valid_frame[seq] = np.asarray(anim["valid"]).astype(np.float32)
        poses_3d[seq] = _root_center(anim["data_3d"])
        w, h = (1920, 1080) if seq in ("TS5", "TS6") else (2048, 2048)
        data_2d = np.array(anim["data_2d"], np.float32)
        data_2d[..., :2] = normalize_screen_coordinates(data_2d[..., :2], w=w, h=h)
        poses_2d[seq] = data_2d
    return poses_3d, poses_2d, valid_frame


def _synthetic_mm(rng, frames):
    """One synthetic sequence in mm with the root trajectory in joint 14 and
    joint 0 at the origin (the pelvis-rooted layout)."""
    p3, p2 = make_sequence(rng, frames)
    p3mm = p3 * 1000.0
    p3mm[:, ROOT_JOINT] = p3mm[:, 0]
    p3mm[:, 0] = 0.0
    return p3mm, p2


def make_synthetic(seed=0, n_train=4, n_test=2, frames=120):
    """Synthetic 3DHP-like data (mm, valid masks) for the tests and the smoke
    run: (poses_3d_train, poses_2d_train, poses_3d_test, poses_2d_test,
    valid), the same numbers as the JAX package's `make_synthetic`."""
    rng = np.random.RandomState(seed)
    poses_3d_train, poses_2d_train = {}, {}
    for i in range(n_train):
        key = (f"S{i}", "Seq1", 0)
        poses_3d_train[key], poses_2d_train[key] = _synthetic_mm(rng, frames)
    poses_3d_test, poses_2d_test, valid = {}, {}, {}
    for i in range(n_test):
        key = f"TS{i+1}"
        poses_3d_test[key], poses_2d_test[key] = _synthetic_mm(rng, frames)
        v = np.ones(frames, np.float32)
        v[rng.rand(frames) < 0.1] = 0.0
        valid[key] = v
    return poses_3d_train, poses_2d_train, poses_3d_test, poses_2d_test, valid

"""Synthetic pose dataset for the tests and the smoke run.

Counterpart of d3dp_tpu/data/synthetic.py: smooth random 3D joint
trajectories projected to 2D with an H36M-like camera model, so the
evaluation pipeline runs end to end without the (absent) real datasets.
Same seed, same numbers as the JAX package's `make_dataset`.
"""

import numpy as np
import torch

from d3dp_tpu_torch.geometry.camera import project_to_2d

# H36M 17-joint symmetry (after 32->17 reduction)
JOINTS_LEFT = [4, 5, 6, 11, 12, 13]
JOINTS_RIGHT = [1, 2, 3, 14, 15, 16]

DEFAULT_CAM = np.array(
    # fx fy cx cy k1 k2 k3 p1 p2 — normalised-units H36M-like intrinsics
    [2.29, 2.287, 0.025, 0.028, -0.207, 0.247, -0.003, -0.001, -0.0014],
    dtype=np.float32,
)


def smooth_noise(rng, T, shape, smoothing=9):
    """Temporally-smoothed gaussian noise (random walk of poses)."""
    x = rng.randn(T + smoothing, *shape).astype(np.float32)
    kernel = np.ones(smoothing, dtype=np.float32) / smoothing
    x = np.apply_along_axis(lambda a: np.convolve(a, kernel, mode="valid"), 0, x)
    return x[:T]


# H36M 17-joint parent chain (after 32->17 reduction, shoulders reparented)
_PARENTS17 = [-1, 0, 1, 2, 0, 4, 5, 0, 7, 8, 9, 8, 11, 12, 8, 14, 15]
_BONE_LEN = np.array([0, 0.13, 0.44, 0.45, 0.13, 0.44, 0.45, 0.23, 0.25,
                      0.12, 0.11, 0.15, 0.28, 0.25, 0.15, 0.28, 0.25],
                     np.float32)


def make_sequence(rng, T, num_joints=17, depth=4.0, structured=False):
    """One synthetic sequence: (pose3d_cam (T,J,3) with absolute root at
    joint 0, pose2d (T,J,2) in normalised screen coords).

    structured=True (`-k structured` on the command line) makes
    skeleton-consistent poses: fixed bone lengths and smooth joint
    rotations, so depth is inferable from 2D foreshortening.
    """
    if structured and num_joints == 17:
        # smooth random unit directions per bone -> forward kinematics
        dirs = smooth_noise(rng, T, (num_joints, 3), smoothing=15)
        dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True) + 1e-6
        local = np.zeros((T, num_joints, 3), np.float32)
        for j, p in enumerate(_PARENTS17):
            if p >= 0:
                local[:, j] = local[:, p] + _BONE_LEN[j] * dirs[:, j]
    else:
        local = 0.35 * smooth_noise(rng, T, (num_joints, 3))
    local[:, 0] = 0.0  # root-relative: joint 0 at origin
    traj = 0.5 * smooth_noise(rng, T, (1, 3))
    traj[..., 2] += depth  # keep in front of camera
    pose_abs = local + traj  # camera-space absolute positions
    pose2d = project_to_2d(
        torch.from_numpy(pose_abs.reshape(1, -1, 3)),
        torch.from_numpy(DEFAULT_CAM[None]),
    ).numpy().reshape(T, num_joints, 2)
    # 3D targets in the reference convention: root keeps trajectory,
    # others root-relative (main.py:107)
    pose3d = pose_abs.copy()
    pose3d[:, 1:] -= pose3d[:, :1]
    return pose3d.astype(np.float32), pose2d.astype(np.float32)


def make_dataset(seed=0, lengths=(300, 250, 400), num_joints=17):
    """Lists of (cam, pose3d, pose2d) matching the fetch() output format."""
    rng = np.random.RandomState(seed)
    cams, poses_3d, poses_2d = [], [], []
    for T in lengths:
        p3, p2 = make_sequence(rng, T, num_joints)
        cams.append(DEFAULT_CAM.copy())
        poses_3d.append(p3)
        poses_2d.append(p2)
    return cams, poses_3d, poses_2d

"""Camera model on torch tensors: screen normalisation, world<->camera
transforms, and the Human3.6M projection (radial k1-k3 + tangential).

Counterpart of d3dp_tpu/geometry/camera.py (reference: common/camera.py).
`project_to_2d` drives JPMA (J-Agg) hypothesis selection in the evaluator.
"""

import numpy as np
import torch

from d3dp_tpu_torch.geometry.quaternion import qinverse, qrot


def normalize_screen_coordinates(X, w, h):
    """Map pixel coords so [0, w] -> [-1, 1], preserving aspect ratio.
    numpy or torch, shape (..., 2). (reference: common/camera.py:7-11)"""
    assert X.shape[-1] == 2
    if isinstance(X, np.ndarray):
        # float64 offset, like the reference's bare Python list
        return X / w * 2 - np.array([1, h / w])
    return X / w * 2 - torch.tensor([1.0, h / w], dtype=X.dtype, device=X.device)


def image_coordinates(X, w, h):
    """Inverse of :func:`normalize_screen_coordinates`. (camera.py:14-18)"""
    assert X.shape[-1] == 2
    if isinstance(X, np.ndarray):
        return (X + np.array([1, h / w])) * w / 2
    return (X + torch.tensor([1.0, h / w], dtype=X.dtype, device=X.device)) * w / 2


def _f32(a, like):
    return torch.as_tensor(a, dtype=torch.float32, device=like.device)


def world_to_camera(X, R, t):
    """World -> camera frame. X: (..., 3); R: (4,) quaternion; t: (3,).
    (reference: common/camera.py:21-23)"""
    Rt = qinverse(_f32(R, X)).expand(*X.shape[:-1], 4)
    return qrot(Rt, X - _f32(t, X))


def camera_to_world(X, R, t):
    """Camera -> world frame. (reference: common/camera.py:26-27)"""
    Rq = _f32(R, X).expand(*X.shape[:-1], 4)
    return qrot(Rq, X) + _f32(t, X)


def _broadcast_cam(camera_params, X_ndim):
    """Insert middle axes so (N, 9) broadcasts against (N, ..., 3)."""
    while camera_params.dim() < X_ndim:
        camera_params = camera_params.unsqueeze(1)
    return camera_params


def project_to_2d(X, camera_params):
    """Project camera-space 3D points to 2D with H36M distortion.

    X: (N, ..., 3); camera_params: (N, 9) = focal(2) + center(2) +
    radial k1-3(3) + tangential(2). Returns (N, ..., 2).
    (reference: common/camera.py:30-60)
    """
    assert X.shape[-1] == 3
    assert camera_params.dim() == 2 and camera_params.shape[-1] == 9
    assert X.shape[0] == camera_params.shape[0]
    camera_params = _broadcast_cam(camera_params, X.dim())
    f = camera_params[..., :2]
    c = camera_params[..., 2:4]
    k = camera_params[..., 4:7]
    p = camera_params[..., 7:]

    XX = torch.clamp(X[..., :2] / X[..., 2:], -1.0, 1.0)
    r2 = torch.sum(XX**2, dim=-1, keepdim=True)
    radial = 1 + torch.sum(k * torch.cat((r2, r2**2, r2**3), dim=-1), dim=-1, keepdim=True)
    tan = torch.sum(p * XX, dim=-1, keepdim=True)
    XXX = XX * (radial + tan) + p * r2
    return f * XXX + c


def project_to_2d_linear(X, camera_params):
    """Pinhole-only projection (focal + center). (camera.py:62-83)"""
    assert X.shape[-1] == 3
    assert camera_params.dim() == 2 and camera_params.shape[-1] == 9
    assert X.shape[0] == camera_params.shape[0]
    camera_params = _broadcast_cam(camera_params, X.dim())
    f = camera_params[..., :2]
    c = camera_params[..., 2:4]
    XX = torch.clamp(X[..., :2] / X[..., 2:], -1.0, 1.0)
    return f * XX + c


def uvd2xyz(uvd, gt_3d, cam):
    """Lift uv+depth to root-relative xyz. uvd/gt_3d: (N, T, V, 3); cam: (N, 9).
    Joint 0's depth is taken from the ground-truth root.
    (reference: common/camera.py:85-114)"""
    N = uvd.shape[0]
    z_root = gt_3d[:, :, :1, 2:]
    z_global = torch.cat([z_root, uvd[:, :, 1:, 2:] + z_root], dim=2)
    cam_f = cam[..., :2].reshape(N, 1, 1, 2)
    cam_c = cam[..., 2:4].reshape(N, 1, 1, 2)
    xy = (uvd[..., :2] - cam_c) * z_global / cam_f
    xyz_global = torch.cat((xy, z_global), dim=-1)
    return xyz_global - xyz_global[:, :, :1, :]

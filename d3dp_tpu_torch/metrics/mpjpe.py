"""Protocol-1 (MPJPE) metrics over multi-hypothesis diffusion output.

Counterpart of d3dp_tpu/metrics/mpjpe.py (reference: common/loss.py).
Functions take torch tensors on any device and return per-DDIM-step (K,)
vectors:

  predicted: (B, K, H, F, J, 3)  -- K DDIM steps, H hypotheses
  target:    (B, F, J, 3)

  P-Best `mpjpe_diffusion`, P-Agg its `mean_pos=True`, J-Best
  `mpjpe_diffusion_all_min`, J-Agg (JPMA) `mpjpe_diffusion_reproj`;
  the valid-frame-masked 3DHP form `mpjpe_diffusion_3dhp`; and the
  reference's other losses `n_mpjpe` and the velocity errors.

A data-parallel rank scores its rows of a micro-batch: it passes `total`,
the global micro-batch's weight sum, so the ranks' results sum to the
global mean, and P-Best's `per_hypothesis=True`, the (K, H) means before
the minimum over H, which is taken after the sum over the ranks.
"""

import torch
import torch.nn.functional as F


def _norm(x, dim=-1):
    return torch.sqrt(torch.sum(torch.square(x), dim=dim))


def _check_shapes(predicted, target):
    if predicted.shape != target.shape:
        raise ValueError(f"shapes differ: {tuple(predicted.shape)} vs {tuple(target.shape)}")


def mpjpe(predicted, target, return_joints_err=False):
    """Mean per-joint position error. (loss.py:6-20) With
    `return_joints_err`, also the per-joint mean over all other axes, in mm
    (the input in metres)."""
    _check_shapes(predicted, target)
    errors = _norm(predicted - target)
    if return_joints_err:
        per_joint = torch.mean(errors.reshape(-1, errors.shape[-1]), dim=0) * 1000
        return torch.mean(errors), per_joint
    return torch.mean(errors)


def _wmean(errors, weights, keep_axes, total=None):
    """Mean of `errors` over all axes except `keep_axes`, with optional (B,)
    0/1 `weights` masking padded rows of axis 0 (fixed-size eval batches);
    `total` replaces the weights' sum in the denominator."""
    reduce_axes = tuple(a for a in range(errors.dim()) if a not in keep_axes)
    if weights is None:
        return torch.mean(errors, dim=reduce_axes)
    w = weights.reshape((-1,) + (1,) * (errors.dim() - 1)).to(errors.dtype)
    n_other = 1
    for a in reduce_axes:
        if a != 0:
            n_other *= errors.shape[a]
    total = torch.sum(weights) if total is None else total
    return torch.sum(errors * w, dim=reduce_axes) / (total * n_other)


def mpjpe_diffusion(predicted, target, mean_pos=False, weights=None, total=None,
                    per_hypothesis=False):
    """P-Best (default) or P-Agg (mean_pos) MPJPE, -> (K,). (loss.py:78-107)
    P-Best with `per_hypothesis`: the (K, H) means, before the minimum."""
    if not mean_pos:
        errors = _norm(predicted - target[:, None, None])  # (B,K,H,F,J)
        per_kh = _wmean(errors, weights, keep_axes=(1, 2), total=total)  # (K,H)
        return per_kh if per_hypothesis else torch.amin(per_kh, dim=1)
    mean_pose = torch.mean(predicted, dim=2)  # (B,K,F,J,3)
    errors = _norm(mean_pose - target[:, None])  # (B,K,F,J)
    return _wmean(errors, weights, keep_axes=(1,), total=total)


def mpjpe_diffusion_all_min(predicted, target, mean_pos=False, weights=None, total=None):
    """J-Best (per-joint oracle over H) or P-Agg, -> (K,). (loss.py:22-52)"""
    if not mean_pos:
        errors = _norm(predicted - target[:, None, None])  # (B,K,H,F,J)
        return _wmean(torch.amin(errors, dim=2), weights, keep_axes=(1,), total=total)
    return mpjpe_diffusion(predicted, target, mean_pos=True, weights=weights, total=total)


def joint_select_by_reproj(errors_2d):
    """One-hot selector over H minimising 2D reprojection error.
    errors_2d: (B,K,H,F,J) -> one-hot of the same shape (ties go to the
    lowest index, like torch.min)."""
    idx = torch.argmin(errors_2d, dim=2)  # (B,K,F,J)
    onehot = F.one_hot(idx, errors_2d.shape[2]).to(errors_2d.dtype)  # (B,K,F,J,H)
    return onehot.movedim(-1, 2)


def mpjpe_diffusion_reproj(predicted, target, reproj_2d, target_2d, weights=None, total=None):
    """J-Agg / JPMA: per-joint hypothesis chosen by 2D reprojection, -> (K,).
    reproj_2d: (B,K,H,F,J,2); target_2d: (B,F,J,2). (loss.py:54-76)"""
    errors = _norm(predicted - target[:, None, None])  # (B,K,H,F,J)
    errors_2d = _norm(reproj_2d - target_2d[:, None, None])
    onehot = joint_select_by_reproj(errors_2d)
    errors_select = torch.sum(errors * onehot, dim=2)  # (B,K,F,J)
    return _wmean(errors_select, weights, keep_axes=(1,), total=total)


def mpjpe_diffusion_3dhp(predicted, target, valid_frame, mean_pos=False, total=None,
                         per_hypothesis=False):
    """Valid-frame-masked P-Best (or P-Agg with mean_pos) for MPI-INF-3DHP,
    -> (K,). valid_frame: (B, F) 0/1. A masked mean rather than the
    reference's boolean indexing, so the shapes stay fixed. `total`
    replaces the mask's sum in the denominator; `per_hypothesis` as in
    mpjpe_diffusion. (reference: common/loss.py:109-145)"""
    mask = valid_frame.to(predicted.dtype)  # (B, F)
    J = predicted.shape[4]
    denom = (torch.sum(mask) if total is None else total) * J
    if not mean_pos:
        errors = _norm(predicted - target[:, None, None]) * mask[:, None, None, :, None]
        per_kh = torch.sum(errors, dim=(0, 3, 4)) / denom
        return per_kh if per_hypothesis else torch.amin(per_kh, dim=1)
    mean_pose = torch.mean(predicted, dim=2)
    errors = _norm(mean_pose - target[:, None]) * mask[:, None, :, None]
    return torch.sum(errors, dim=(0, 2, 3)) / denom


def n_mpjpe(predicted, target):
    """MPJPE after the optimal per-frame scale of the prediction.
    (loss.py:398-408)"""
    _check_shapes(predicted, target)
    norm_predicted = torch.mean(torch.sum(predicted ** 2, dim=3, keepdim=True), dim=2,
                                keepdim=True)
    norm_target = torch.mean(torch.sum(target * predicted, dim=3, keepdim=True), dim=2,
                             keepdim=True)
    return mpjpe(norm_target / norm_predicted * predicted, target)


def mean_velocity_error_train(predicted, target, axis=1):
    """Mean per-joint velocity error along the frame axis. (loss.py:411-423)"""
    _check_shapes(predicted, target)
    vel_p = torch.diff(predicted, dim=axis)
    vel_t = torch.diff(target, dim=axis)
    return torch.mean(_norm(vel_p - vel_t))


def mean_velocity_error(predicted, target, axis=0):
    """The reference's numpy-convention variant: frames on axis 0.
    (loss.py:425-434)"""
    return mean_velocity_error_train(predicted, target, axis=axis)

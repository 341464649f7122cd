"""Protocol-1 (MPJPE) metrics over multi-hypothesis diffusion output.

Counterpart of d3dp_tpu/metrics/mpjpe.py (reference: common/loss.py).
Functions take torch tensors on any device and return per-DDIM-step (K,)
vectors:

  predicted: (B, K, H, F, J, 3)  -- K DDIM steps, H hypotheses
  target:    (B, F, J, 3)

  P-Best `mpjpe_diffusion`, P-Agg its `mean_pos=True`, J-Best
  `mpjpe_diffusion_all_min`, J-Agg (JPMA) `mpjpe_diffusion_reproj`.
"""

import torch
import torch.nn.functional as F


def _norm(x, dim=-1):
    return torch.sqrt(torch.sum(torch.square(x), dim=dim))


def mpjpe(predicted, target):
    """Mean per-joint position error. (loss.py:6-20)"""
    if predicted.shape != target.shape:
        raise ValueError(f"shapes differ: {tuple(predicted.shape)} vs {tuple(target.shape)}")
    return torch.mean(_norm(predicted - target))


def _wmean(errors, weights, keep_axes):
    """Mean of `errors` over all axes except `keep_axes`, with optional (B,)
    0/1 `weights` masking padded rows of axis 0 (fixed-size eval batches)."""
    reduce_axes = tuple(a for a in range(errors.dim()) if a not in keep_axes)
    if weights is None:
        return torch.mean(errors, dim=reduce_axes)
    w = weights.reshape((-1,) + (1,) * (errors.dim() - 1)).to(errors.dtype)
    n_other = 1
    for a in reduce_axes:
        if a != 0:
            n_other *= errors.shape[a]
    return torch.sum(errors * w, dim=reduce_axes) / (torch.sum(weights) * n_other)


def mpjpe_diffusion(predicted, target, mean_pos=False, weights=None):
    """P-Best (default) or P-Agg (mean_pos) MPJPE, -> (K,). (loss.py:78-107)"""
    if not mean_pos:
        errors = _norm(predicted - target[:, None, None])  # (B,K,H,F,J)
        per_kh = _wmean(errors, weights, keep_axes=(1, 2))  # (K,H)
        return torch.amin(per_kh, dim=1)
    mean_pose = torch.mean(predicted, dim=2)  # (B,K,F,J,3)
    errors = _norm(mean_pose - target[:, None])  # (B,K,F,J)
    return _wmean(errors, weights, keep_axes=(1,))


def mpjpe_diffusion_all_min(predicted, target, mean_pos=False, weights=None):
    """J-Best (per-joint oracle over H) or P-Agg, -> (K,). (loss.py:22-52)"""
    if not mean_pos:
        errors = _norm(predicted - target[:, None, None])  # (B,K,H,F,J)
        return _wmean(torch.amin(errors, dim=2), weights, keep_axes=(1,))
    return mpjpe_diffusion(predicted, target, mean_pos=True, weights=weights)


def joint_select_by_reproj(errors_2d):
    """One-hot selector over H minimising 2D reprojection error.
    errors_2d: (B,K,H,F,J) -> one-hot of the same shape (ties go to the
    lowest index, like torch.min)."""
    idx = torch.argmin(errors_2d, dim=2)  # (B,K,F,J)
    onehot = F.one_hot(idx, errors_2d.shape[2]).to(errors_2d.dtype)  # (B,K,F,J,H)
    return onehot.movedim(-1, 2)


def mpjpe_diffusion_reproj(predicted, target, reproj_2d, target_2d, weights=None):
    """J-Agg / JPMA: per-joint hypothesis chosen by 2D reprojection, -> (K,).
    reproj_2d: (B,K,H,F,J,2); target_2d: (B,F,J,2). (loss.py:54-76)"""
    errors = _norm(predicted - target[:, None, None])  # (B,K,H,F,J)
    errors_2d = _norm(reproj_2d - target_2d[:, None, None])
    onehot = joint_select_by_reproj(errors_2d)
    errors_select = torch.sum(errors * onehot, dim=2)  # (B,K,F,J)
    return _wmean(errors_select, weights, keep_axes=(1,))

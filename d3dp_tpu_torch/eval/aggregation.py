"""Pose selection by aggregation mode over a (B, K, H, F, J, 3) hypothesis
stack: P-Agg, P-Best, J-Best and J-Agg return poses, not errors.

Counterpart of d3dp_tpu/eval/aggregation.py (reference: the 3DHP export
path, main_3dhp.py:781-835, which hands the selected poses to the PCK/AUC
harness). Selections are gathers along H, so the selected values are the
hypotheses' own; argmin ties go to the first hypothesis.
"""

import torch


def _norm(x):
    return torch.sqrt(torch.sum(torch.square(x), dim=-1))


def _take_h(preds, idx):
    """preds (B, K, H, F, J, 3) at hypothesis idx (B, K, F, J) per joint ->
    (B, K, F, J, 3)."""
    return torch.take_along_dim(preds, idx[:, :, None, :, :, None], dim=2)[:, :, 0]


def select_p_agg(preds):
    """Mean pose over hypotheses. (B, K, H, F, J, 3) -> (B, K, F, J, 3)."""
    return torch.mean(preds, dim=2)


def select_p_best(preds, target, weights=None):
    """The hypothesis of least mean error per DDIM step, one for the whole
    micro-batch, as the reference picks it (main_3dhp.py:787-797).
    -> (B, K, F, J, 3). `weights`: optional (B,) 0/1 mask keeping padded
    windows out of the selection statistic (the reference never pads)."""
    errors = _norm(preds - target[:, None, None])  # (B, K, H, F, J)
    if weights is not None:
        w = weights[:, None, None, None, None].to(errors.dtype)
        denom = torch.sum(weights) * errors.shape[3] * errors.shape[4]
        per_kh = torch.sum(errors * w, dim=(0, 3, 4)) / denom  # (K, H)
    else:
        per_kh = torch.mean(errors, dim=(0, 3, 4))  # (K, H)
    idx = torch.argmin(per_kh, dim=1)  # (K,)
    return torch.take_along_dim(preds, idx[None, :, None, None, None, None], dim=2)[:, :, 0]


def select_j_best(preds, target):
    """Per-joint oracle hypothesis. -> (B, K, F, J, 3). (main_3dhp.py:800-803)"""
    errors = _norm(preds - target[:, None, None])  # (B, K, H, F, J)
    return _take_h(preds, torch.argmin(errors, dim=2))


def select_j_agg(preds, reproj_2d, target_2d):
    """Per-joint hypothesis of least 2D reprojection error (JPMA).
    reproj_2d: (B, K, H, F, J, 2); target_2d: (B, F, J, 2).
    -> (B, K, F, J, 3). (main_3dhp.py:806-835)"""
    errors_2d = _norm(reproj_2d - target_2d[:, None, None])  # (B, K, H, F, J)
    return _take_h(preds, torch.argmin(errors_2d, dim=2))

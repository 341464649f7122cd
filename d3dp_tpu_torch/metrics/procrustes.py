"""Protocol-2 (P-MPJPE) metrics on the device: rigid alignment by a batched
SVD of (M, 3, 3) cross-covariances.

Counterpart of d3dp_tpu/metrics/procrustes.py (reference math:
common/loss.py:148-395). Everything stays on the tensors' device in fp32:
the (M, 3, 3) products follow the fp32 rule of `device.disable_tf32`, which
the entry points apply. Only the sign of det(R) is used, so it comes from
the closed-form 3x3 determinant: the same sign as an LU determinant of an
orthogonal matrix, with no LU and no host synchronization. The SVD itself
(`torch.linalg.svd`) synchronizes with the host on a card to check its
status.
"""

import torch

from d3dp_tpu_torch.metrics.mpjpe import _norm, _wmean, joint_select_by_reproj


def _det3(m):
    """Determinant of each (3, 3) matrix of an (M, 3, 3) stack."""
    return (m[:, 0, 0] * (m[:, 1, 1] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 1])
            - m[:, 0, 1] * (m[:, 1, 0] * m[:, 2, 2] - m[:, 1, 2] * m[:, 2, 0])
            + m[:, 0, 2] * (m[:, 1, 0] * m[:, 2, 1] - m[:, 1, 1] * m[:, 2, 0]))


def procrustes_align(predicted, target):
    """Optimal similarity transform (scale, rotation, translation) per pose.

    predicted, target: (M, J, 3). Returns predicted aligned to target,
    (M, J, 3). (reference math: common/loss.py:148-187)
    """
    muX = torch.mean(target, dim=1, keepdim=True)
    muY = torch.mean(predicted, dim=1, keepdim=True)
    X0 = target - muX
    Y0 = predicted - muY
    normX = torch.sqrt(torch.sum(X0 ** 2, dim=(1, 2), keepdim=True))
    normY = torch.sqrt(torch.sum(Y0 ** 2, dim=(1, 2), keepdim=True))
    X0 = X0 / normX
    Y0 = Y0 / normY

    Hm = torch.matmul(X0.transpose(1, 2), Y0)
    U, s, Vt = torch.linalg.svd(Hm)
    V = Vt.transpose(1, 2)
    Ut = U.transpose(1, 2)
    # an improper rotation (a reflection) becomes the best proper one by
    # flipping the last singular direction and its singular value
    sign = torch.sign(_det3(torch.matmul(V, Ut)))  # (M,)
    flip = torch.ones_like(s)
    flip[:, -1] = sign
    V = V * flip[:, None, :]
    s = s * flip
    R = torch.matmul(V, Ut)

    tr = torch.sum(s, dim=1, keepdim=True)[:, :, None]  # (M, 1, 1)
    a = tr * normX / normY  # scale
    t = muX - a * torch.matmul(muY, R)  # translation
    return a * torch.matmul(predicted, R) + t


def p_mpjpe(predicted, target):
    """Scalar Protocol-2 error over (M, J, 3). (loss.py:148-187)"""
    if predicted.shape != target.shape:
        raise ValueError(f"shapes differ: {tuple(predicted.shape)} vs {tuple(target.shape)}")
    return torch.mean(_norm(procrustes_align(predicted, target) - target))


def _align_hypotheses(predicted, target, mean_pos):
    """Broadcast target, flatten, align. Returns (aligned, target), both
    shaped (B, K, [H,] F, J, 3)."""
    B, K, H, F, J, C = predicted.shape
    if mean_pos:
        predicted = torch.mean(predicted, dim=2)  # (B, K, F, J, 3)
        out_shape = (B, K, F, J, C)
        target_b = target[:, None].expand(out_shape)
    else:
        out_shape = (B, K, H, F, J, C)
        target_b = target[:, None, None].expand(out_shape)
    aligned = procrustes_align(predicted.reshape(-1, J, C), target_b.reshape(-1, J, C))
    return aligned.reshape(out_shape), target_b


def p_mpjpe_diffusion(predicted, target, mean_pos=False, weights=None):
    """P-Best / P-Agg under Protocol 2, -> (K,). (loss.py:262-331)

    `weights`: optional (B,) 0/1 mask excluding padded windows."""
    aligned, target_b = _align_hypotheses(predicted, target, mean_pos)
    errors = _norm(aligned - target_b)
    if not mean_pos:
        return torch.amin(_wmean(errors, weights, keep_axes=(1, 2)), dim=1)
    return _wmean(errors, weights, keep_axes=(1,))


def p_mpjpe_diffusion_all_min(predicted, target, mean_pos=False, weights=None):
    """J-Best / P-Agg under Protocol 2, -> (K,). (loss.py:190-260)"""
    aligned, target_b = _align_hypotheses(predicted, target, mean_pos)
    errors = _norm(aligned - target_b)
    if not mean_pos:
        return _wmean(torch.amin(errors, dim=2), weights, keep_axes=(1,))
    return _wmean(errors, weights, keep_axes=(1,))


def p_mpjpe_diffusion_reproj(predicted, target, reproj_2d, target_2d, weights=None):
    """J-Agg / JPMA under Protocol 2, -> (K,). (loss.py:333-395)"""
    aligned, target_b = _align_hypotheses(predicted, target, mean_pos=False)
    errors = _norm(aligned - target_b)  # (B, K, H, F, J)
    errors_2d = _norm(reproj_2d - target_2d[:, None, None])
    errors_select = torch.sum(errors * joint_select_by_reproj(errors_2d), dim=2)
    return _wmean(errors_select, weights, keep_axes=(1,))

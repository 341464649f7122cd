"""Host (NumPy/LAPACK) backend for the Protocol-2 metric family.

A copy of the JAX package's host Protocol-2 path: numbers match the
reference bit-for-bit (the reference computes P2 on host numpy,
common/loss.py:190-395). The evaluator calls these for P2 reporting.
"""

import numpy as np


def _similarity_transform_np(src, dst):
    """Least-squares similarity (scale, rotation, translation) mapping each
    (J, 3) cloud in `src` onto the matching cloud in `dst` (Kabsch/Umeyama).

    The rotation comes from the SVD of the cross-covariance of the centred,
    unit-Frobenius-normalised clouds; an improper rotation (det = -1, i.e. a
    reflection) is repaired by negating the weakest singular direction.
    Floating-point op order deliberately matches the reference p_mpjpe
    alignment (common/loss.py:148-186) so host P2 numbers stay bit-identical.

    Returns (scale (M,1,1), rot (M,3,3), trans (M,1,3)); apply as
    `scale * (src @ rot) + trans`.
    """
    src_centre = np.mean(src, axis=1, keepdims=True)
    dst_centre = np.mean(dst, axis=1, keepdims=True)
    src0 = src - src_centre
    dst0 = dst - dst_centre
    src_norm = np.sqrt(np.sum(src0**2, axis=(1, 2), keepdims=True))
    dst_norm = np.sqrt(np.sum(dst0**2, axis=(1, 2), keepdims=True))

    cov = (dst0 / dst_norm).transpose(0, 2, 1) @ (src0 / src_norm)
    u, sing, vt = np.linalg.svd(cov)
    v = vt.transpose(0, 2, 1)
    ut = u.transpose(0, 2, 1)

    # sign of det(v @ ut) tells whether the best orthogonal map reflects;
    # flipping the last column of v (and the matching singular value, which
    # feeds the scale) converts it to the best proper rotation
    flip = np.sign(np.linalg.det(v @ ut))
    v[:, :, -1] *= flip[:, None]
    sing[:, -1] *= flip
    rot = v @ ut

    scale = np.sum(sing, axis=1)[:, None, None] * dst_norm / src_norm
    trans = dst_centre - scale * (src_centre @ rot)
    return scale, rot, trans


def procrustes_align_np(predicted, target):
    """Batched similarity alignment; predicted/target: (M, J, 3) numpy."""
    scale, rot, trans = _similarity_transform_np(predicted, target)
    return scale * (predicted @ rot) + trans


def _norm(x, axis=-1):
    return np.linalg.norm(x, axis=axis)


def _align_hypotheses_np(predicted, target, mean_pos):
    B, K, H, F, J, C = predicted.shape
    if mean_pos:
        predicted = np.mean(predicted, axis=2)
        target_b = np.broadcast_to(target[:, None], (B, K, F, J, C))
        flat = (B * K * F, J, C)
        out = (B, K, F, J, C)
    else:
        target_b = np.broadcast_to(target[:, None, None], (B, K, H, F, J, C))
        flat = (B * K * H * F, J, C)
        out = (B, K, H, F, J, C)
    aligned = procrustes_align_np(
        np.ascontiguousarray(predicted.reshape(flat)),
        np.ascontiguousarray(target_b.reshape(flat)),
    )
    return aligned.reshape(out), target_b


def p_mpjpe_np(predicted, target):
    aligned = procrustes_align_np(predicted, target)
    return np.mean(_norm(aligned - target))


def p_mpjpe_diffusion_np(predicted, target, mean_pos=False, per_hypothesis=False):
    """P-Best / P-Agg; P-Best with `per_hypothesis` the (K, H) means before
    the minimum (a data-parallel rank's share)."""
    aligned, target_b = _align_hypotheses_np(predicted, target, mean_pos)
    errors = _norm(aligned - target_b)
    if not mean_pos:
        per_kh = np.mean(errors, axis=(0, 3, 4))
        return per_kh if per_hypothesis else np.min(per_kh, axis=1)
    return np.mean(errors, axis=(0, 2, 3))


def p_mpjpe_diffusion_all_min_np(predicted, target, mean_pos=False):
    aligned, target_b = _align_hypotheses_np(predicted, target, mean_pos)
    errors = _norm(aligned - target_b)
    if not mean_pos:
        return np.mean(np.min(errors, axis=2), axis=(0, 2, 3))
    return np.mean(errors, axis=(0, 2, 3))


def p_mpjpe_diffusion_reproj_np(predicted, target, reproj_2d, target_2d):
    aligned, target_b = _align_hypotheses_np(predicted, target, mean_pos=False)
    errors = _norm(aligned - target_b)  # (B,K,H,F,J)
    errors_2d = _norm(reproj_2d - target_2d[:, None, None])
    idx = np.argmin(errors_2d, axis=2)  # (B,K,F,J)
    errors_select = np.take_along_axis(errors, idx[:, :, None], axis=2)[:, :, 0]
    return np.mean(errors_select, axis=(0, 2, 3))

"""Quaternion rotation primitives on torch tensors.

Counterpart of d3dp_tpu/geometry/quaternion.py (reference:
common/quaternion.py:3-28): broadcasting functions, no host-side tiling.
"""

import torch


def qrot(q, v):
    """Rotate vector(s) `v` by unit quaternion(s) `q`.

    q: (..., 4) in (w, x, y, z) convention; v: (..., 3); shapes broadcast.
    Returns (..., 3).
    """
    assert q.shape[-1] == 4
    assert v.shape[-1] == 3
    qvec = q[..., 1:]
    qvec, v = torch.broadcast_tensors(qvec, v)
    uv = torch.linalg.cross(qvec, v, dim=-1)
    uuv = torch.linalg.cross(qvec, uv, dim=-1)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def qinverse(q):
    """Inverse of unit quaternion(s): conjugate. q: (..., 4) -> (..., 4)."""
    assert q.shape[-1] == 4
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)

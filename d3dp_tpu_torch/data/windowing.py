"""Fixed-length eval windowing: split ragged sequences into static-shape
(W, receptive_field, J, C) windows and stitch predictions back.

Semantics match the reference exactly (main.py:267-299, main_3dhp.py:283-332):
non-overlapping windows, RIGHT-ALIGNED final window (double-covers the tail
overlap; the stitcher lets the last window win), replicate-pad sequences
shorter than the receptive field. Fixed shapes keep every micro-batch the
same size on the device; the ragged sequence never reaches it.
"""

import numpy as np


def window_sequence(seq, receptive_field):
    """(T, ...) -> (W, receptive_field, ...) numpy windows."""
    T = seq.shape[0]
    rf = receptive_field
    out_num = T // rf + (1 if T % rf else 0)
    out_num = max(out_num, 1)

    out = np.empty((out_num, rf) + seq.shape[1:], dtype=seq.dtype)
    for i in range(out_num - 1):
        out[i] = seq[i * rf : (i + 1) * rf]
    if T < rf:
        pad = [(0, rf - T)] + [(0, 0)] * (seq.ndim - 1)
        seq = np.pad(seq, pad, mode="edge")
    out[-1] = seq[-rf:]
    return out


def stitch_windows(windows, total_frames):
    """Invert window_sequence along the frame axis: (W, rf, ...) ->
    (total_frames, ...). The final (right-aligned) window overwrites the
    tail, as pose_post_process does (main_3dhp.py:327-332)."""
    W, rf = windows.shape[:2]
    out = np.empty((total_frames,) + windows.shape[2:], dtype=windows.dtype)
    for i in range(W - 1):
        out[i * rf : (i + 1) * rf] = windows[i]
    if total_frames >= rf:
        out[-rf:] = windows[-1]
    else:
        out[:] = windows[-1][:total_frames]
    return out


def window_batch(poses_2d, poses_3d, receptive_field, valid_frame=None):
    """Window a (T, J, 2) / (T, J, 3) pair, and an optional (T,) valid mask
    as float32, together."""
    w2d = window_sequence(poses_2d, receptive_field)
    w3d = window_sequence(poses_3d, receptive_field)
    if valid_frame is None:
        return w2d, w3d
    wv = window_sequence(np.asarray(valid_frame).astype(np.float32), receptive_field)
    return w2d, w3d, wv

"""Fixed-length eval windowing: split ragged sequences into static-shape
(W, receptive_field, J, C) windows.

Semantics match the reference exactly (main.py:267-299): non-overlapping
windows, RIGHT-ALIGNED final window (double-covers the tail overlap),
replicate-pad sequences shorter than the receptive field. Fixed shapes keep
every micro-batch the same size on the device; the ragged sequence never
reaches it.
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

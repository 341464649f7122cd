"""Fixed-length eval windowing: split ragged sequences into static-shape
(W, receptive_field, J, C) windows and stitch predictions back.

Semantics match the reference exactly (main.py:267-299, main_3dhp.py:283-332):
non-overlapping windows, RIGHT-ALIGNED final window (double-covers the tail
overlap; the stitcher lets the last window win), replicate-pad sequences
shorter than the receptive field. Fixed shapes keep every micro-batch the
same size on the device; the ragged sequence never reaches it.
"""

import numpy as np
import torch

from d3dp_tpu_torch.parallel.mesh import batch_rows, gather_rows, rank_noise, round_up_batch


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


def stitch_hypotheses(preds, total_frames):
    """stitch_windows of every (K, H) hypothesis: (W, K, H, rf, J, 3) ->
    (K, H, total_frames, J, 3)."""
    K, H = preds.shape[1:3]
    return np.stack([np.stack([stitch_windows(preds[:, k, h], total_frames) for h in range(H)])
                     for k in range(K)])


def sample_windows(d3dp, w2d, w2d_flip, bs, generator, mesh=None):
    """DDIM-sample every window, `bs` windows a `D3DP.sample` call ->
    (W, K, H, rf, J, 3) numpy.

    The window sampler shared by main_draw's hypothesis collector and the
    in-the-wild pipeline. The last micro-batch is padded to `bs` rows with
    copies of its first row, so every call has one shape; the pad rows are
    dropped, and the stack is copied to the host once, after the loop.
    `generator` is a torch.Generator on the sampler's device, drawn from in
    order across the micro-batches.

    Under a data-parallel `mesh` (parallel/mesh.py) bs is rounded up to the
    batch quantum, each rank draws the global micro-batch's noise and
    samples its rows, and the ranks' rows are gathered once, after the loop
    (the reference wraps its model in DataParallel, main.py:246-248).
    """
    W = w2d.shape[0]
    dev = d3dp.device
    rows = slice(None)
    if mesh is not None:
        bs = round_up_batch(bs, mesh)
        rows = batch_rows(bs, mesh)
    parts = []
    for lo in range(0, W, bs):
        hi = min(lo + bs, W)
        pad = bs - (hi - lo)
        a, b = w2d[lo:hi], w2d_flip[lo:hi]
        if pad:
            a = np.concatenate([a, np.repeat(a[:1], pad, 0)], 0)
            b = np.concatenate([b, np.repeat(b[:1], pad, 0)], 0)
        kw = dict(generator=generator)
        if mesh is not None:
            kw = dict(noise_override=rank_noise(d3dp, bs, generator, mesh))
        out = d3dp.sample(torch.from_numpy(np.ascontiguousarray(a[rows], np.float32)).to(dev),
                          torch.from_numpy(np.ascontiguousarray(b[rows], np.float32)).to(dev), **kw)
        parts.append(out if mesh is not None else out[: hi - lo])
    if mesh is not None:
        return gather_rows(parts, bs, mesh)[:W].cpu().numpy()
    return torch.cat(parts).cpu().numpy()


def window_batch(poses_2d, poses_3d, receptive_field, valid_frame=None):
    """Window a (T, J, 2) / (T, J, 3) pair, and an optional (T,) valid mask
    as float32, together."""
    w2d = window_sequence(poses_2d, receptive_field)
    w3d = window_sequence(poses_3d, receptive_field)
    if valid_frame is None:
        return w2d, w3d
    wv = window_sequence(np.asarray(valid_frame).astype(np.float32), receptive_field)
    return w2d, w3d, wv

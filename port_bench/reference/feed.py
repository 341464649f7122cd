"""The inputs the evaluation and the training loop see, worked out again
from the raw sequences (D3DP's main.py windowing and common/generators.py
ChunkedGenerator), in numpy.
"""

import numpy as np


def flip_sequence(seq, left, right):
    """(T, J, C) mirrored: x negated, left and right joints swapped."""
    out = seq.copy()
    out[..., 0] *= -1
    out[:, list(left) + list(right)] = out[:, list(right) + list(left)]
    return out


def windows(seq, rf):
    """(T, ...) -> (W, rf, ...): consecutive windows of rf frames, the last
    one right-aligned on the sequence's end (edge-padded below rf frames)."""
    T = seq.shape[0]
    n = max(-(-T // rf), 1)
    if T < rf:
        seq = np.concatenate([seq, np.repeat(seq[-1:], rf - T, 0)])
    out = [seq[i * rf:(i + 1) * rf] for i in range(n - 1)]
    out.append(seq[-rf:])
    return np.stack(out)


def eval_microbatch(cam, pose3d, pose2d, rf, bs, b, kps_left, kps_right):
    """Micro-batch b of one sequence as the evaluation samples and scores
    it: bs windows, the last micro-batch filled up with copies of its first
    window. Returns (n real windows, x2d, x2d_flip, target root-zeroed,
    traj, cam (bs, 9)), arrays of bs rows."""
    w2d = windows(pose2d, rf)
    w2f = windows(flip_sequence(pose2d, kps_left, kps_right), rf)
    w3d = windows(pose3d, rf)
    lo, hi = b * bs, min((b + 1) * bs, len(w2d))
    n = hi - lo

    def take(a):
        x = a[lo:hi]
        return np.concatenate([x, np.repeat(x[:1], bs - n, 0)]) if bs > n else x

    x3d = take(w3d)
    traj = x3d[:, :, :1].copy()
    target = x3d.copy()
    target[:, :, 0] = 0.0
    return n, take(w2d), take(w2f), target, traj, np.tile(cam, (bs, 1))


def microbatches(lengths, rf, bs):
    """[(sequence index, micro-batch index, real windows)] of a list of
    sequence lengths, in the evaluation's order."""
    out = []
    for s, T in enumerate(lengths):
        W = max(-(-T // rf), 1)
        for b in range(-(-W // bs)):
            out.append((s, b, min(bs, W - b * bs)))
    return out


def chunk_table(lengths, chunk, augment):
    """The training epoch's chunks, (N, 4) int64 rows (sequence, start, end,
    flip): each sequence tiled by ceil(T / chunk) windows centred on it,
    with `augment` all of them again mirrored after the plain ones."""
    rows = []
    for s, T in enumerate(lengths):
        n = -(-T // chunk)
        lead = (n * chunk - T) // 2
        starts = np.arange(n, dtype=np.int64) * chunk - lead
        plain = np.stack([np.full(n, s, np.int64), starts, starts + chunk,
                          np.zeros(n, np.int64)], axis=1)
        rows.append(plain)
        if augment:
            mirrored = plain.copy()
            mirrored[:, 3] = 1
            rows.append(mirrored)
    return np.concatenate(rows)


def train_batches(poses_3d, poses_2d, chunk, batch, shuffle_seed, augment, kps, joints,
                  count):
    """The first `count` training batches of an epoch shuffled by
    RandomState(shuffle_seed): [(x2d (batch, chunk, J, 2), x3d (batch,
    chunk, J, 3), weights (batch,))], edge padding at the sequences' ends,
    the mirrored chunks flipped (2D by `kps`, 3D by `joints`: (left,
    right)), a short last batch filled with its first row at weight 0."""
    table = chunk_table([p.shape[0] for p in poses_2d], chunk, augment)
    table = np.random.RandomState(shuffle_seed).permutation(table)

    def cut(seq, start, end):
        lo, hi = max(start, 0), min(end, seq.shape[0])
        return np.pad(seq[lo:hi], [(lo - start, end - hi)] + [(0, 0)] * (seq.ndim - 1), "edge")

    out = []
    for i in range(count):
        rows = table[i * batch:(i + 1) * batch]
        x2d, x3d = [], []
        for s, start, end, flip in rows:
            a, b = cut(poses_2d[s], start, end), cut(poses_3d[s], start, end)
            if flip:
                a, b = flip_sequence(a, *kps), flip_sequence(b, *joints)
            x2d.append(a)
            x3d.append(b)
        w = np.zeros(batch, np.float32)
        w[:len(rows)] = 1
        while len(x2d) < batch:
            x2d.append(x2d[0])
            x3d.append(x3d[0])
        out.append((np.stack(x2d).astype(np.float32), np.stack(x3d).astype(np.float32), w))
    return out

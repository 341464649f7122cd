"""Host-side batch generators for training and evaluation.

Counterpart of d3dp_tpu/data/generators.py (reference:
common/generators.py): the same chunk boundaries (centred offset), edge
padding, horizontal-flip augmentation (with the camera sign flips),
per-epoch shuffling from a dedicated np.random.RandomState whose state can
be saved and restored, and the fixed-size batch mode (`pad_last`) that pads
the final partial batch and returns a 0/1 weight mask. Same seed, same
batches as the JAX package's Python extraction path (`use_native=False`);
the native chunk assembler is not ported.

`UnchunkedGenerator` is reduced to what the evaluators use: flip-TTA is
fused into the sampler, so it never builds a flipped duplicate; the 3DHP
evaluator's (valid, key) yield is kept.
"""

from itertools import zip_longest

import numpy as np


def chunk_schedule(seq_lengths, chunk_length, augment):
    """The epoch chunk table: one (seq_idx, start, end, flip) row per
    training window, as an (N, 4) int64 array.

    Each sequence of T frames is tiled by ceil(T / chunk_length) windows,
    centred on the sequence: half their overshoot (floor) lies before frame
    0 (those frames are edge-padded at extraction). With `augment`, every
    sequence contributes its windows twice, flip=0 rows first, then the same
    windows with flip=1 (common/generators.py:41-49).
    """
    per_seq = []
    for seq_idx, n_frames in enumerate(seq_lengths):
        n_windows = -(-n_frames // chunk_length)  # ceil
        lead = (n_windows * chunk_length - n_frames) // 2
        starts = np.arange(n_windows, dtype=np.int64) * chunk_length - lead
        rows = np.stack([np.full(n_windows, seq_idx, np.int64), starts,
                         starts + chunk_length, np.zeros(n_windows, np.int64)], axis=1)
        per_seq.append(rows)
        if augment:
            mirrored = rows.copy()
            mirrored[:, 3] = 1
            per_seq.append(mirrored)
    if not per_seq:
        return np.zeros((0, 4), np.int64)
    return np.concatenate(per_seq, axis=0)


class ChunkedGenerator:
    """Training generator: shuffled fixed-length chunks with flip augment.
    (reference: common/generators.py:12-171)

    next_epoch() yields (cam (B, 9), pose3d (B, L, J, 3), pose2d (B, L, J, 2))
    per batch, plus weights (B,) with `pad_last`; cam and pose3d are None
    where not given. `endless` makes next_epoch() run forever, resuming
    mid-epoch where the previous iterator stopped.
    """

    def __init__(self, batch_size, cameras, poses_3d, poses_2d, chunk_length,
                 shuffle=True, random_seed=1234, augment=False, kps_left=None,
                 kps_right=None, joints_left=None, joints_right=None, endless=False,
                 pad_last=False):
        if poses_3d is not None and len(poses_3d) != len(poses_2d):
            raise ValueError("poses_3d and poses_2d differ in sequence count")
        if cameras is not None and len(cameras) != len(poses_2d):
            raise ValueError("cameras and poses_2d differ in sequence count")
        if poses_3d is not None:
            for p2, p3 in zip(poses_2d, poses_3d):
                if p2.shape[0] != p3.shape[0]:
                    raise ValueError(f"sequence lengths differ: {p2.shape} vs {p3.shape}")

        self.chunks = chunk_schedule([p.shape[0] for p in poses_2d], chunk_length, augment)
        self.num_batches = -(-len(self.chunks) // batch_size)
        self.batch_size = batch_size
        self.random = np.random.RandomState(random_seed)
        self.shuffle = shuffle
        self.endless = endless
        self.state = None
        self.pad_last = pad_last
        self.chunk_length = chunk_length
        self.cameras = cameras
        self.poses_3d = poses_3d
        self.poses_2d = poses_2d
        self.augment = augment
        self.kps_left = kps_left
        self.kps_right = kps_right
        self.joints_left = joints_left
        self.joints_right = joints_right

    def random_state(self):
        return self.random

    def set_random_state(self, random):
        self.random = random

    def _epoch_order(self):
        """(first_batch, chunk_table) of the epoch being (re)entered: a fresh
        shuffle, or the saved mid-epoch position in endless mode."""
        if self.state is not None:
            return self.state
        if self.shuffle:
            return 0, self.random.permutation(self.chunks)
        return 0, self.chunks

    @staticmethod
    def _extract(seqs, seq_i, start, end):
        """Chunk [start, end) of seqs[seq_i] with edge padding."""
        seq = seqs[seq_i]
        low, high = max(start, 0), min(end, seq.shape[0])
        chunk = seq[low:high]
        if low - start or end - high:
            chunk = np.pad(chunk, [(low - start, end - high)] + [(0, 0)] * (seq.ndim - 1),
                           "edge")
        return chunk

    @staticmethod
    def _flip(chunk, left, right):
        chunk = chunk.copy()
        chunk[..., 0] *= -1
        chunk[:, left + right] = chunk[:, right + left]
        return chunk

    def assemble_batch(self, chunks):
        """One batch from a slice of the chunk table: flip augmentation (with
        the camera sign flips), edge padding, fixed-shape pad_last rows. A
        pure function of its inputs."""
        n = len(chunks)
        bs = self.batch_size if self.pad_last else n
        weights = np.zeros((bs,), dtype=np.float32)
        weights[:n] = 1.0

        batch_cam = None
        if self.cameras is not None:
            batch_cam = np.empty((bs, self.cameras[0].shape[-1]), dtype=np.float32)
            for i, (seq_i, _, _, flip) in enumerate(chunks):
                cam = np.array(self.cameras[int(seq_i)], dtype=np.float32)
                if flip:
                    cam[2] *= -1  # principal point cx
                    cam[7] *= -1  # tangential p1
                batch_cam[i] = cam

        L = self.chunk_length
        batch_2d = np.empty((bs, L) + self.poses_2d[0].shape[1:], dtype=np.float32)
        batch_3d = None
        if self.poses_3d is not None:
            batch_3d = np.empty((bs, L) + self.poses_3d[0].shape[1:], dtype=np.float32)
        for i, (seq_i, start, end, flip) in enumerate(chunks):
            seq_i, start, end = int(seq_i), int(start), int(end)
            chunk_2d = self._extract(self.poses_2d, seq_i, start, end)
            batch_2d[i] = self._flip(chunk_2d, self.kps_left, self.kps_right) if flip \
                else chunk_2d
            if batch_3d is not None:
                chunk_3d = self._extract(self.poses_3d, seq_i, start, end)
                batch_3d[i] = self._flip(chunk_3d, self.joints_left, self.joints_right) \
                    if flip else chunk_3d

        if self.pad_last and n < bs:
            # pad rows replicate row 0 (finite values: the masked loss
            # multiplies them by 0, and 0 * NaN would poison the gradients)
            batch_2d[n:] = batch_2d[0]
            if batch_3d is not None:
                batch_3d[n:] = batch_3d[0]
            if batch_cam is not None:
                batch_cam[n:] = batch_cam[0]

        if self.pad_last:
            return batch_cam, batch_3d, batch_2d, weights
        return batch_cam, batch_3d, batch_2d

    def next_epoch(self):
        while True:
            start_idx, table = self._epoch_order()
            for b_i in range(start_idx, self.num_batches):
                chunks = table[b_i * self.batch_size:(b_i + 1) * self.batch_size]
                batch = self.assemble_batch(chunks)
                if self.endless:
                    self.state = (b_i + 1, table)
                yield batch
            if not self.endless:
                return
            self.state = None


class UnchunkedGenerator:
    """Yields (cam (1, 9), pose3d (1, T, J, 3), pose2d (1, T, J, 2)) per
    sequence; cam and pose3d are None where not given. With `valid_frames`
    (one (T,) mask per sequence, the 3DHP test set) it yields (cam, pose3d,
    pose2d, valid, key) instead, `key` from `keys` or the sequence's index.
    (reference: common/generators.py:174-249 and its 3DHP dict variant)"""

    def __init__(self, cameras, poses_3d, poses_2d, valid_frames=None, keys=None):
        if poses_3d is not None and len(poses_3d) != len(poses_2d):
            raise ValueError("poses_3d and poses_2d differ in sequence count")
        if cameras is not None and len(cameras) != len(poses_2d):
            raise ValueError("cameras and poses_2d differ in sequence count")
        if valid_frames is not None and len(valid_frames) != len(poses_2d):
            raise ValueError("valid_frames and poses_2d differ in sequence count")
        self.cameras = [] if cameras is None else cameras
        self.poses_3d = [] if poses_3d is None else poses_3d
        self.poses_2d = poses_2d
        self.valid_frames = valid_frames
        self.keys = keys

    def num_frames(self):
        return sum(p.shape[0] for p in self.poses_2d)

    def next_epoch(self):
        for idx, (seq_cam, seq_3d, seq_2d) in enumerate(
                zip_longest(self.cameras, self.poses_3d, self.poses_2d)):
            item = (None if seq_cam is None else np.expand_dims(seq_cam, 0),
                    None if seq_3d is None else np.expand_dims(seq_3d, 0),
                    np.expand_dims(seq_2d, 0))
            if self.valid_frames is not None:
                key = self.keys[idx] if self.keys is not None else idx
                item += (self.valid_frames[idx], key)
            yield item

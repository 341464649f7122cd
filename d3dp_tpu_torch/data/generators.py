"""Host-side batch generators for training and evaluation.

Counterpart of d3dp_tpu/data/generators.py (reference:
common/generators.py): the same chunk boundaries (centred offset), edge
padding, horizontal-flip augmentation (with the camera sign flips),
per-epoch shuffling from a dedicated np.random.RandomState whose state can
be saved and restored, and the fixed-size batch mode (`pad_last`) that pads
the final partial batch and returns a 0/1 weight mask. Same seed, same
batches as the JAX package's. With `use_native` (the default, as in JAX)
the chunks are extracted and flipped by the C++ assembler (`data/native.py`),
bit for bit the numpy path's; where it cannot be built the numpy path runs,
and `ChunkedGenerator.assembler` says which ran ("native" or "numpy").

`UnchunkedGenerator` yields whole sequences; with `augment` it stacks the
flipped copy beside each (the evaluators fuse flip-TTA into the sampler and
leave it off), and it keeps the 3DHP evaluator's (valid, key) yield.
`UnchunkedGeneratorSeq2Seq` edge-pads each sequence by pad +- causal_shift
first (the reference's UnchunkedGenerator_Seq2Seq).
"""

from itertools import zip_longest

import numpy as np


def flip_sequence(seq, left, right):
    """A mirrored copy of (T, J, C) poses: x negated, left and right joints
    swapped."""
    seq = seq.copy()
    seq[..., 0] *= -1
    seq[:, left + right] = seq[:, right + left]
    return seq


def flip_camera(cam):
    """A copy of a (9,) intrinsic vector for the mirrored image: the
    principal point cx and the tangential p1 change sign."""
    cam = np.array(cam)
    cam[2] *= -1
    cam[7] *= -1
    return cam


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
    mid-epoch where the previous iterator stopped. `pad` and `causal_shift`
    are stored and, as in the JAX package, take no part in the extraction.
    """

    def __init__(self, batch_size, cameras, poses_3d, poses_2d, chunk_length,
                 pad=0, causal_shift=0, shuffle=True, random_seed=1234, augment=False,
                 kps_left=None, kps_right=None, joints_left=None, joints_right=None,
                 endless=False, pad_last=False, use_native=True):
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
        self.pad = pad
        self.causal_shift = causal_shift
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
        self._native = None
        if use_native:
            from d3dp_tpu_torch.data import native

            if native.available():
                self._native = native
                self._banks = [native.SequenceBank(poses_2d)] + (
                    [native.SequenceBank(poses_3d)] if poses_3d is not None else [])
                self._flips = [self._flip_tables(poses_2d[0], kps_left, kps_right)]
                if poses_3d is not None:
                    self._flips.append(self._flip_tables(poses_3d[0], joints_left,
                                                         joints_right))
        # which extraction path assemble_batch takes
        self.assembler = "numpy" if self._native is None else "native"

    @staticmethod
    def _flip_tables(seq, left, right):
        """(joint permutation, channel signs) of the flip on (T, J, C) poses:
        left and right joints swapped, x negated."""
        perm = np.arange(seq.shape[1])
        if left is not None:
            perm[list(left)] = right
            perm[list(right)] = left
        return perm, np.array([-1.0] + [1.0] * (seq.shape[2] - 1), np.float32)

    def num_frames(self):
        """Chunks an epoch yields, counting the pad_last rows."""
        return self.num_batches * self.batch_size

    def batch_num(self):
        """Batches an epoch yields."""
        return self.num_batches

    def random_state(self):
        return self.random

    def set_random_state(self, random):
        self.random = random

    def augment_enabled(self):
        return self.augment

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
                cam = np.asarray(self.cameras[int(seq_i)], dtype=np.float32)
                batch_cam[i] = flip_camera(cam) if flip else cam

        L = self.chunk_length
        batch_2d = np.empty((bs, L) + self.poses_2d[0].shape[1:], dtype=np.float32)
        batch_3d = None
        if self.poses_3d is not None:
            batch_3d = np.empty((bs, L) + self.poses_3d[0].shape[1:], dtype=np.float32)
        if self._native is not None:
            table = np.asarray(chunks, dtype=np.int64).reshape(n, 4)
            for bank, (perm, sign), out in zip(self._banks, self._flips, (batch_2d, batch_3d)):
                self._native.assemble_chunks(bank, table, L, perm, sign, out=out[:n])
            chunks = ()  # extracted
        for i, (seq_i, start, end, flip) in enumerate(chunks):
            seq_i, start, end = int(seq_i), int(start), int(end)
            chunk_2d = self._extract(self.poses_2d, seq_i, start, end)
            batch_2d[i] = flip_sequence(chunk_2d, self.kps_left, self.kps_right) if flip \
                else chunk_2d
            if batch_3d is not None:
                chunk_3d = self._extract(self.poses_3d, seq_i, start, end)
                batch_3d[i] = flip_sequence(chunk_3d, self.joints_left, self.joints_right) \
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
    """Yields (cam (N, 9), pose3d (N, T, J, 3), pose2d (N, T, J, 2)) per
    sequence, N = 1, or N = 2 with `augment`: the flipped copy (keypoints
    by `kps_left`/`kps_right`, poses by `joints_left`/`joints_right`, the
    camera's cx and p1 negated) stacked after the original. cam and pose3d
    are None where not given. With `valid_frames` (one (T,) mask per
    sequence, the 3DHP test set) it yields (cam, pose3d, pose2d, valid, key)
    instead, `key` from `keys` or the sequence's index.
    (reference: common/generators.py:174-249 and its 3DHP dict variant; the
    constructor's `augment` is honoured, where the reference sets it False
    and relies on set_augment). `pad` and `causal_shift` are kept for
    `UnchunkedGeneratorSeq2Seq`; this generator does not pad, as the JAX
    package's does not."""

    def __init__(self, cameras, poses_3d, poses_2d, pad=0, causal_shift=0, augment=False,
                 kps_left=None, kps_right=None, joints_left=None, joints_right=None,
                 valid_frames=None, keys=None):
        if poses_3d is not None and len(poses_3d) != len(poses_2d):
            raise ValueError("poses_3d and poses_2d differ in sequence count")
        if cameras is not None and len(cameras) != len(poses_2d):
            raise ValueError("cameras and poses_2d differ in sequence count")
        if valid_frames is not None and len(valid_frames) != len(poses_2d):
            raise ValueError("valid_frames and poses_2d differ in sequence count")
        self.cameras = [] if cameras is None else cameras
        self.poses_3d = [] if poses_3d is None else poses_3d
        self.poses_2d = poses_2d
        self.augment = bool(augment)
        self.kps_left = kps_left
        self.kps_right = kps_right
        self.joints_left = joints_left
        self.joints_right = joints_right
        self.valid_frames = valid_frames
        self.keys = keys
        self.pad = pad
        self.causal_shift = causal_shift

    def num_frames(self):
        return sum(p.shape[0] for p in self.poses_2d)

    def augment_enabled(self):
        return self.augment

    def set_augment(self, augment):
        self.augment = augment

    def next_epoch(self):
        for idx, (seq_cam, seq_3d, seq_2d) in enumerate(
                zip_longest(self.cameras, self.poses_3d, self.poses_2d)):
            cam = None if seq_cam is None else [seq_cam]
            p3 = None if seq_3d is None else [seq_3d]
            p2 = [seq_2d]
            if self.augment:
                if cam is not None:
                    cam.append(flip_camera(seq_cam))
                if p3 is not None:
                    p3.append(flip_sequence(seq_3d, self.joints_left, self.joints_right))
                p2.append(flip_sequence(seq_2d, self.kps_left, self.kps_right))
            item = tuple(None if x is None else np.stack(x) for x in (cam, p3, p2))
            if self.valid_frames is not None:
                key = self.keys[idx] if self.keys is not None else idx
                item += (self.valid_frames[idx], key)
            yield item


class UnchunkedGeneratorSeq2Seq(UnchunkedGenerator):
    """`UnchunkedGenerator` whose sequences, 2D and 3D, are edge-padded by
    pad + causal_shift frames before and pad - causal_shift after; yields
    (cam, pose3d, pose2d) per sequence, with the flipped copy stacked after
    each with `augment`. (reference: common/generators.py:251-327, the
    JAX package's UnchunkedGeneratorSeq2Seq; no entry point uses it)"""

    def next_epoch(self):
        pad = ((self.pad + self.causal_shift, self.pad - self.causal_shift), (0, 0), (0, 0))
        for seq_cam, seq_3d, seq_2d in zip_longest(self.cameras, self.poses_3d, self.poses_2d):
            seq_2d = np.pad(seq_2d, pad, "edge")
            seq_3d = None if seq_3d is None else np.pad(seq_3d, pad, "edge")
            cam = None if seq_cam is None else [seq_cam]
            p3 = None if seq_3d is None else [seq_3d]
            p2 = [seq_2d]
            if self.augment:
                if cam is not None:
                    cam.append(flip_camera(seq_cam))
                if p3 is not None:
                    p3.append(flip_sequence(seq_3d, self.joints_left, self.joints_right))
                p2.append(flip_sequence(seq_2d, self.kps_left, self.kps_right))
            yield tuple(None if x is None else np.stack(x) for x in (cam, p3, p2))

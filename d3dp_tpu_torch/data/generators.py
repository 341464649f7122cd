"""Evaluation generator: one whole sequence per step.

Counterpart of `UnchunkedGenerator` in d3dp_tpu/data/generators.py
(reference: common/generators.py:174-249), reduced to what the evaluator
uses: flip-TTA is fused into the sampler, so the generator never builds a
flipped duplicate. The training generators come with the training slice.
"""

from itertools import zip_longest

import numpy as np


class UnchunkedGenerator:
    """Yields (cam (1, 9), pose3d (1, T, J, 3), pose2d (1, T, J, 2)) per
    sequence; cam and pose3d are None where not given."""

    def __init__(self, cameras, poses_3d, poses_2d):
        if poses_3d is not None and len(poses_3d) != len(poses_2d):
            raise ValueError("poses_3d and poses_2d differ in sequence count")
        if cameras is not None and len(cameras) != len(poses_2d):
            raise ValueError("cameras and poses_2d differ in sequence count")
        self.cameras = [] if cameras is None else cameras
        self.poses_3d = [] if poses_3d is None else poses_3d
        self.poses_2d = poses_2d

    def next_epoch(self):
        for seq_cam, seq_3d, seq_2d in zip_longest(self.cameras, self.poses_3d,
                                                   self.poses_2d):
            yield (None if seq_cam is None else np.expand_dims(seq_cam, 0),
                   None if seq_3d is None else np.expand_dims(seq_3d, 0),
                   np.expand_dims(seq_2d, 0))

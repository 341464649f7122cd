"""Kinematic skeleton metadata: parents, left/right symmetry, joint removal.

Counterpart of d3dp_tpu/data/skeleton.py (reference: common/skeleton.py),
numpy only.
"""

import numpy as np


class Skeleton:
    def __init__(self, parents, joints_left, joints_right):
        assert len(joints_left) == len(joints_right)
        self._parents = np.array(parents)
        self._joints_left = list(joints_left)
        self._joints_right = list(joints_right)
        self._compute_metadata()

    def num_joints(self):
        return len(self._parents)

    def parents(self):
        return self._parents

    def has_children(self):
        return self._has_children

    def children(self):
        return self._children

    def joints_left(self):
        return self._joints_left

    def joints_right(self):
        return self._joints_right

    def remove_joints(self, joints_to_remove):
        """Drop joints, reparenting children through removed ancestors and
        remapping symmetry lists. Returns the kept joint indices.
        (reference: common/skeleton.py:24-62)
        """
        joints_to_remove = set(joints_to_remove)
        valid_joints = [j for j in range(len(self._parents)) if j not in joints_to_remove]

        # walk each joint's parent chain past removed joints
        parents = self._parents.copy()
        for i in range(len(parents)):
            while parents[i] in joints_to_remove:
                parents[i] = parents[parents[i]]

        # shift indices down to account for removals before them
        index_offsets = np.zeros(len(parents), dtype=int)
        new_parents = []
        for i, parent in enumerate(parents):
            if i not in joints_to_remove:
                new_parents.append(parent - index_offsets[parent])
            else:
                index_offsets[i:] += 1
        self._parents = np.array(new_parents)

        self._joints_left = [
            j - index_offsets[j] for j in self._joints_left if j in set(valid_joints)
        ]
        self._joints_right = [
            j - index_offsets[j] for j in self._joints_right if j in set(valid_joints)
        ]
        self._compute_metadata()
        return valid_joints

    def _compute_metadata(self):
        self._has_children = np.zeros(len(self._parents), dtype=bool)
        for parent in self._parents:
            if parent != -1:
                self._has_children[parent] = True
        self._children = [[] for _ in self._parents]
        for i, parent in enumerate(self._parents):
            if parent != -1:
                self._children[parent].append(i)

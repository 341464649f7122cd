"""Base container for motion-capture datasets.

Holds the subject -> action -> {positions, cameras} mapping plus skeleton
and frame-rate metadata that the loaders (h36m.py) populate. Provides joint
removal that keeps the skeleton and every stored pose array consistent.
Counterpart of d3dp_tpu/data/mocap.py (reference: common/mocap_dataset.py).
"""


class MocapDataset:
    def __init__(self, fps, skeleton):
        self._fps = fps
        self._skeleton = skeleton
        self._data = {}
        self._cameras = {}

    # -- joint surgery ----------------------------------------------------
    def remove_joints(self, joints_to_remove):
        """Drop joints from the skeleton AND every loaded pose array."""
        kept = self._skeleton.remove_joints(joints_to_remove)
        for actions in self._data.values():
            for entry in actions.values():
                if "positions" in entry:
                    entry["positions"] = entry["positions"][:, kept]
        return kept

    # -- accessors ---------------------------------------------------------
    def __getitem__(self, subject):
        return self._data[subject]

    def __contains__(self, subject):
        return subject in self._data

    def subjects(self):
        return self._data.keys()

    def actions(self, subject):
        return list(self._data[subject].keys())

    def cameras(self):
        return self._cameras

    def skeleton(self):
        return self._skeleton

    def fps(self):
        return self._fps

    def supports_semi_supervised(self):
        return False

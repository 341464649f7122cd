"""Dataset preparation for the command line.

Counterpart of d3dp_tpu/cli/data_prep.py, with numpy where the JAX version
uses jnp (reference main.py:83-208): world->camera transform with
per-subject extrinsics, trajectory kept in joint 0, screen-normalised 2D
keypoints, subject/action fetch with optional subset/downsample; and the
synthetic dataset with the same interfaces (the reference repo ships no
data).
"""

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from d3dp_tpu_torch.data.synthetic import DEFAULT_CAM, JOINTS_LEFT, JOINTS_RIGHT, make_sequence
from d3dp_tpu_torch.geometry.camera import normalize_screen_coordinates, world_to_camera
from d3dp_tpu_torch.utils.misc import deterministic_random


@dataclass
class PreparedData:
    """Everything the train/eval orchestration needs."""

    keypoints: dict  # subject -> action -> [per-camera (T,J,2) arrays]
    poses_3d: dict  # subject -> action -> [per-camera (T,J,3) arrays]
    cameras: dict  # subject -> [camera dicts with 'intrinsic']
    kps_left: list
    kps_right: list
    joints_left: list
    joints_right: list
    num_joints: int = 17
    fps: int = 50
    skeleton: object = None
    keypoints_metadata: dict = field(default_factory=dict)

    def subjects(self):
        return list(self.keypoints.keys())

    def actions_of(self, subject):
        return list(self.keypoints[subject].keys())


def prepare_h36m(args):
    """Load data_3d_h36m.npz + data_2d_h36m_<keypoints>.npz.

    (reference: main.py:83-145)
    """
    from d3dp_tpu_torch.data.h36m import Human36mDataset

    dataset_path = os.path.join("data", f"data_3d_{args.dataset}.npz")
    if not os.path.exists(dataset_path):
        raise FileNotFoundError(
            f"{dataset_path} not found — see DATASETS.md for dataset setup, "
            "or use '-d synthetic' for a no-data smoke run")
    dataset = Human36mDataset(dataset_path)

    # world -> camera, root-split trajectory (main.py:99-109)
    for subject in dataset.subjects():
        for action in dataset[subject].keys():
            anim = dataset[subject][action]
            if "positions" in anim:
                positions_3d = []
                for cam in anim["cameras"]:
                    pos_3d = world_to_camera(
                        torch.as_tensor(anim["positions"], dtype=torch.float32),
                        cam["orientation"],
                        cam["translation"],
                    ).numpy()
                    pos_3d[:, 1:] -= pos_3d[:, :1]
                    positions_3d.append(pos_3d)
                anim["positions_3d"] = positions_3d

    kp_path = os.path.join("data", f"data_2d_{args.dataset}_{args.keypoints}.npz")
    if not os.path.exists(kp_path):
        raise FileNotFoundError(
            f"{kp_path} not found — see DATASETS.md for dataset setup")
    keypoints_file = np.load(kp_path, allow_pickle=True)
    keypoints_metadata = keypoints_file["metadata"].item()
    keypoints_symmetry = keypoints_metadata["keypoints_symmetry"]
    kps_left, kps_right = list(keypoints_symmetry[0]), list(keypoints_symmetry[1])
    joints_left = list(dataset.skeleton().joints_left())
    joints_right = list(dataset.skeleton().joints_right())
    keypoints = keypoints_file["positions_2d"].item()

    # consistency checks + truncation (main.py:120-137)
    for subject in dataset.subjects():
        assert subject in keypoints, f"Subject {subject} missing from 2D detections"
        for action in dataset[subject].keys():
            assert action in keypoints[subject], (
                f"Action {action} of subject {subject} missing from 2D detections")
            if "positions_3d" not in dataset[subject][action]:
                continue
            for cam_idx in range(len(keypoints[subject][action])):
                mocap_length = dataset[subject][action]["positions_3d"][cam_idx].shape[0]
                assert keypoints[subject][action][cam_idx].shape[0] >= mocap_length
                if keypoints[subject][action][cam_idx].shape[0] > mocap_length:
                    keypoints[subject][action][cam_idx] = (
                        keypoints[subject][action][cam_idx][:mocap_length])

    # screen normalisation (main.py:139-145); confidence channels dropped
    # like the in-the-wild variant (main_in_the_wild.py:172) — the denoiser
    # conditions on (x, y) only
    for subject in keypoints.keys():
        for action in keypoints[subject]:
            for cam_idx, kps in enumerate(keypoints[subject][action]):
                cam = dataset.cameras()[subject][cam_idx]
                kps = np.ascontiguousarray(kps[..., :2])
                kps[...] = normalize_screen_coordinates(
                    kps, w=cam["res_w"], h=cam["res_h"])
                keypoints[subject][action][cam_idx] = kps

    poses_3d = {
        s: {a: dataset[s][a].get("positions_3d") for a in dataset[s].keys()}
        for s in dataset.subjects()
    }
    return PreparedData(
        keypoints=keypoints,
        poses_3d=poses_3d,
        cameras=dataset.cameras(),
        kps_left=kps_left,
        kps_right=kps_right,
        joints_left=joints_left,
        joints_right=joints_right,
        fps=dataset.fps(),
        skeleton=dataset.skeleton(),
        keypoints_metadata=keypoints_metadata,
    )


def prepare_synthetic(args):
    """Self-consistent synthetic stand-in with the same interfaces.

    `-k structured` switches to skeleton-consistent poses (learnable depth);
    the default is unstructured smooth noise."""
    from d3dp_tpu_torch.data.h36m import H36M_JOINTS_REMOVED, h36m_skeleton

    skeleton = h36m_skeleton()
    skeleton.remove_joints(H36M_JOINTS_REMOVED)
    skeleton._parents[11] = 8
    skeleton._parents[14] = 8

    rng = np.random.RandomState(args.seed)
    frames = args.synthetic_frames
    n_actions = 3
    cam_dict = {
        "intrinsic": DEFAULT_CAM.copy(),
        "res_w": 1000,
        "res_h": 1000,
        "azimuth": np.float32(70),
        "orientation": np.array([1.0, 0, 0, 0], np.float32),
        "translation": np.zeros(3, np.float32),
        "id": "synthetic",
    }
    keypoints, poses_3d, cameras = {}, {}, {}
    for subject in ("S1", "S5", "S6", "S7", "S8", "S9", "S11"):
        keypoints[subject], poses_3d[subject] = {}, {}
        cameras[subject] = [cam_dict]
        for a in range(n_actions):
            T = frames // n_actions
            p3, p2 = make_sequence(
                rng, T, structured=(args.keypoints == "structured"))
            action = f"Act{a} 1"
            keypoints[subject][action] = [p2]
            poses_3d[subject][action] = [p3]
    return PreparedData(
        keypoints=keypoints,
        poses_3d=poses_3d,
        cameras=cameras,
        kps_left=list(JOINTS_LEFT),
        kps_right=list(JOINTS_RIGHT),
        joints_left=list(JOINTS_LEFT),
        joints_right=list(JOINTS_RIGHT),
        skeleton=skeleton,
        keypoints_metadata={
            "num_joints": 17,
            "keypoints_symmetry": (list(JOINTS_LEFT), list(JOINTS_RIGHT)),
            "layout_name": "synthetic",
        },
    )


def prepare_data(args):
    if args.dataset == "synthetic":
        return prepare_synthetic(args)
    if args.dataset == "h36m":
        return prepare_h36m(args)
    raise KeyError(f"Invalid dataset: {args.dataset}")


def fetch(data: PreparedData, subjects, action_filter=None, subset=1,
          downsample=1, parse_3d_poses=True):
    """Select (cams, poses_3d, poses_2d) lists. (reference: main.py:155-208)"""
    out_poses_3d, out_poses_2d, out_camera_params = [], [], []
    for subject in subjects:
        for action in data.keypoints[subject].keys():
            if action_filter is not None:
                if not any(action.startswith(a) for a in action_filter):
                    continue
            poses_2d = data.keypoints[subject][action]
            for p in poses_2d:
                out_poses_2d.append(p)
            if subject in data.cameras:
                cams = data.cameras[subject]
                assert len(cams) == len(poses_2d), "Camera count mismatch"
                for cam in cams:
                    if "intrinsic" in cam:
                        out_camera_params.append(cam["intrinsic"])
            if parse_3d_poses and data.poses_3d[subject].get(action) is not None:
                poses_3d = data.poses_3d[subject][action]
                assert len(poses_3d) == len(poses_2d), "Camera count mismatch"
                for p in poses_3d:
                    out_poses_3d.append(p)

    if len(out_camera_params) == 0:
        out_camera_params = None
    if len(out_poses_3d) == 0:
        out_poses_3d = None

    stride = downsample
    if subset < 1:
        for i in range(len(out_poses_2d)):
            n_frames = int(round(len(out_poses_2d[i]) // stride * subset) * stride)
            start = deterministic_random(
                0, len(out_poses_2d[i]) - n_frames + 1, str(len(out_poses_2d[i])))
            out_poses_2d[i] = out_poses_2d[i][start : start + n_frames : stride]
            if out_poses_3d is not None:
                out_poses_3d[i] = out_poses_3d[i][start : start + n_frames : stride]
    elif stride > 1:
        for i in range(len(out_poses_2d)):
            out_poses_2d[i] = out_poses_2d[i][::stride]
            if out_poses_3d is not None:
                out_poses_3d[i] = out_poses_3d[i][::stride]

    return out_camera_params, out_poses_3d, out_poses_2d

"""In-the-wild video -> 2D keypoints -> multi-hypothesis 3D poses.

Counterpart of d3dp_tpu/in_the_wild/inference.py (reference:
in_the_wild/videopose_diffusion.py, in_the_wild/utils.py): external 2D
detectors (AlphaPose / HRNet from the video-to-pose3D repo) or precomputed
keypoints in an npz beside the video, the COCO keypoint symmetry, screen
normalisation by the frame size, 2D-only windowed DDIM sampling, window
stitching, camera-to-world with the fixed H36M rotation, the height rebase,
the two .npy exports and per-frame 3D plots. cv2 (frame size, video
splitting) and matplotlib (the plots) are imported where they are used:
`lift_keypoints` runs without either. `inference_video` samples on every
card by default, one process a card, as the command lines do; rank 0 writes
the exports and the plots.
"""

import os
import time

import numpy as np
import torch

from d3dp_tpu_torch.cli.arguments import device_of, launch, parse_args
from d3dp_tpu_torch.data.generators import flip_sequence
from d3dp_tpu_torch.data.windowing import sample_windows, stitch_hypotheses, window_sequence
from d3dp_tpu_torch.device import disable_tf32, resolve_device
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.geometry.camera import camera_to_world, normalize_screen_coordinates
from d3dp_tpu_torch.models import MixSTEConfig
from d3dp_tpu_torch.parallel import process_index, shard_model_params
from d3dp_tpu_torch.train.checkpoint_io import load_any

# COCO-17 keypoint layout of the external detectors
COCO_METADATA = {
    "layout_name": "coco",
    "num_joints": 17,
    "keypoints_symmetry": [[1, 3, 5, 7, 9, 11, 13, 15],
                           [2, 4, 6, 8, 10, 12, 14, 16]],
}
JOINTS_LEFT = [4, 5, 6, 11, 12, 13]
JOINTS_RIGHT = [1, 2, 3, 14, 15, 16]

# fixed H36M camera rotation for the world-frame display
# (in_the_wild/videopose_diffusion.py:181)
H36M_ROT = np.array([0.14070565, -0.15007018, -0.7552408, 0.62232804], dtype=np.float32)


class Timer:
    """Wall-clock context timer. (in_the_wild/utils.py:87-98)"""

    def __init__(self, message):
        self.message = message

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        print(f"{self.message} --- elapsed {time.time() - self.start:.2f} s")


def get_detector_2d(detector_name):
    """A 2D keypoint generator by name: 'alpha_pose' and 'hr_pose' import
    from the external video-to-pose3D repo (on sys.path, reference
    README.md:81-86); 'npz' loads the (N, 17, 2) `kpts` of the npz beside
    the video."""
    def get_alpha_pose():
        from joints_detectors.Alphapose.gene_npz import generate_kpts as alpha_pose
        return alpha_pose

    def get_hr_pose():
        from joints_detectors.hrnet.pose_estimation.video import generate_kpts as hr_pose
        return hr_pose

    def get_npz():
        def load_npz(video_path):
            return np.load(os.path.splitext(video_path)[0] + ".npz")["kpts"]
        return load_npz

    detector_map = {"alpha_pose": get_alpha_pose, "hr_pose": get_hr_pose, "npz": get_npz}
    if detector_name not in detector_map:
        raise ValueError(f"2D detector: {detector_name} not implemented yet!")
    return detector_map[detector_name]()


def split_video(video_path, segment_frames=1000, out_dir=None):
    """Split a long video into fixed-length segments (cv2), returning the
    written paths. (reference: in_the_wild/utils.py:139)"""
    import cv2

    out_dir = out_dir or os.path.dirname(video_path) or "."
    base = os.path.splitext(os.path.basename(video_path))[0]
    cap = cv2.VideoCapture(video_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    paths, writer, idx, n = [], None, 0, 0
    try:
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            if n % segment_frames == 0:
                if writer is not None:
                    writer.release()
                path = os.path.join(out_dir, f"{base}_part{idx:03d}.mp4")
                writer = cv2.VideoWriter(path, fourcc, fps, (w, h))
                paths.append(path)
                idx += 1
            writer.write(frame)
            n += 1
    finally:
        if writer is not None:
            writer.release()
        cap.release()
    return paths


def video_frame_size(video_path):
    """(width, height) of a video's frames (cv2)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    return w, h


def sample_video_keypoints(d3dp, keypoints_norm, rf, bs, generator, mesh=None):
    """2D-only windowed sampling of a normalised COCO-layout (Ftot, 17, 2)
    track, with its keypoint-symmetry flip -> stitched (K, H, Ftot, 17, 3)
    numpy. `generator`: a torch.Generator on the sampler's device; `mesh`
    as in `sample_windows`."""
    kl, kr = COCO_METADATA["keypoints_symmetry"]
    seq = np.asarray(keypoints_norm, np.float32)
    w2d = window_sequence(seq, rf)
    w2d_f = window_sequence(flip_sequence(seq, kl, kr), rf)
    return stitch_hypotheses(sample_windows(d3dp, w2d, w2d_f, bs, generator, mesh),
                             seq.shape[0])


def world_frame(prediction):
    """Camera-frame poses -> the world frame of the fixed H36M rotation, the
    lowest joint of the whole stack at height 0
    (videopose_diffusion.py:180-184)."""
    pred_world = camera_to_world(torch.from_numpy(np.ascontiguousarray(prediction, np.float32)),
                                 H36M_ROT, np.zeros(3, np.float32)).numpy()
    pred_world[..., 2] -= pred_world[..., 2].min()
    return pred_world


def lift_keypoints(args, keypoints, frame_width, frame_height, mesh=None):
    """Pixel keypoints (Ftot, 17, >=2) of a frame_width x frame_height video
    -> (prediction (K, H, Ftot, 17, 3) in the camera frame, the same in the
    world frame, height-rebased), both also saved under
    outputs/<video_name>/. The model is the command line's (`-cs`, `-dep`,
    `-f`, `--dtype`, `--fuse-level`, H, K, reuse) with the COCO joint
    symmetry and the checkpoint `args.evaluate`'s weights; `-b` // `-f`
    windows a sampling call; the noise comes from `--seed`. Runs on the card
    unless `--platform cpu`; `mesh`: this rank's (`cli.arguments.launch`),
    the windows split over its ranks, the exports written by rank 0."""
    device = resolve_device(device_of(args, mesh))
    if device.type == "cuda":
        disable_tf32()
    keypoints_norm = normalize_screen_coordinates(
        np.asarray(keypoints[..., :2], np.float32), w=frame_width, h=frame_height)
    d3dp = D3DP(D3DPConfig(
        model=MixSTEConfig(num_frames=args.number_of_frames, embed_dim=args.cs, depth=args.dep,
                           dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
                           fuse_level=args.fuse_level),
        num_proposals=args.num_proposals, sampling_timesteps=args.sampling_timesteps,
        scale=args.scale, timesteps=args.timestep,
        joints_left=tuple(JOINTS_LEFT), joints_right=tuple(JOINTS_RIGHT),
        flip_tta=args.test_time_augmentation,
        reuse_interval=max(args.ddim_reuse, 1),
        reuse_tap=max(1, min(args.ddim_reuse_tap, args.dep)),
        reuse_tau=args.ddim_reuse_adaptive), device=device, seed=args.seed)
    print("Loading checkpoint", args.evaluate)
    d3dp.model.load_state_dict(load_any(args.evaluate)["model"])
    shard_model_params(d3dp.model, mesh)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    with Timer("sampling"):
        prediction = sample_video_keypoints(
            d3dp, keypoints_norm, args.number_of_frames,
            max(args.batch_size // args.number_of_frames, 1), generator, mesh=mesh)

    pred_world = world_frame(prediction)
    if process_index() == 0:
        save_dir = os.path.join("outputs", args.video_name)
        os.makedirs(save_dir, exist_ok=True)
        np.save(os.path.join(save_dir, f"test_3d_{args.video_name}_output.npy"), prediction)
        np.save(os.path.join(save_dir, f"test_3d_output_{args.video_name}_postprocess.npy"),
                pred_world)
    return prediction, pred_world


def main(args, mesh=None):
    """The whole pipeline for one video (videopose_diffusion.py:64-208):
    keypoints from `args.detector_2d`, frame size from `args.viz_video`,
    `lift_keypoints`, then (unless `args.render_frames` is False) plots of
    the first `--viz-limit` frames (10 by default) under outputs/<video_name>/.
    `mesh`: this rank's, as in lift_keypoints; rank 0 plots. Returns the
    world-frame prediction."""
    # no card and no --platform cpu: fail before the detector
    resolve_device(device_of(args, mesh))
    keypoints = get_detector_2d(args.detector_2d)(args.viz_video)
    frame_width, frame_height = video_frame_size(args.viz_video)
    _, pred_world = lift_keypoints(args, keypoints, frame_width, frame_height, mesh)

    if getattr(args, "render_frames", True) and process_index() == 0:
        from d3dp_tpu_torch.data.h36m import H36M_JOINTS_REMOVED, h36m_skeleton
        from d3dp_tpu_torch.viz.visualization import draw_3d_image

        skeleton = h36m_skeleton()
        skeleton.remove_joints(H36M_JOINTS_REMOVED)
        limit = args.viz_limit if args.viz_limit > 0 else min(pred_world.shape[2], 10)
        # the last DDIM step's hypotheses, the first hypothesis as the overlay
        draw_3d_image(pred_world[:, :, :limit], pred_world[-1, 0, :limit], skeleton, 70.0,
                      args.video_name, "wild", 0, out_dir=os.path.join("outputs", args.video_name))
    return pred_world


def inference_video(video_path, detector_2d, checkpoint=None, argv=None):
    """video -> 2D -> multi-hypothesis 3D. (videopose_diffusion.py:210-232)
    `argv`: the command line's flags (`parse_args(in_the_wild=True)`);
    `checkpoint` defaults to the reference's path. Runs `main` on every
    rank the flags ask for (`cli.arguments.launch`); returns the world-frame
    prediction (rank 0's where the ranks ran in worker processes)."""
    args = parse_args(argv or [], in_the_wild=True)
    args.detector_2d = detector_2d
    basename = os.path.basename(video_path)
    args.video_name = basename[: basename.rfind(".")]
    args.viz_video = video_path
    args.evaluate = checkpoint or "./checkpoint/in_the_wild_best_epoch.bin"
    with Timer(video_path):
        return launch(main, args)

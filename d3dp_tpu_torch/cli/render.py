"""--render: predict one sequence, stitch its windows, export and animate.

Counterpart of d3dp_tpu/cli/render.py (reference: main.py:796-899).
"""

import numpy as np
import torch

from d3dp_tpu_torch.data.generators import UnchunkedGenerator
from d3dp_tpu_torch.data.windowing import stitch_windows
from d3dp_tpu_torch.eval import Evaluator
from d3dp_tpu_torch.geometry.camera import camera_to_world, image_coordinates
from d3dp_tpu_torch.parallel import process_index, round_up_batch


def _to_world(poses, cam, translation):
    return camera_to_world(torch.from_numpy(np.ascontiguousarray(poses, np.float32)),
                           cam["orientation"], translation).numpy()


def run_render(args, data, d3dp_eval, rng=None, noise_provider=None, mesh=None):
    """Sample every window of `--viz-subject`/`--viz-action`/`--viz-camera`
    (`-b` windows a micro-batch), stitch the last DDIM step's first
    hypothesis into a (Ftot, 17, 3) camera-frame sequence, write it to
    `--viz-export` (.npy), and animate it to `--viz-output` (.mp4 or .gif),
    in the world frame, beside the ground truth where the action has one.

    `rng` (a torch.Generator on the sampler's device) or `noise_provider`
    (Evaluator.evaluate's) gives the sampling noise. `mesh` (optional): each
    micro-batch's windows split over its ranks (`-b` rounded up to a
    multiple of dp), the export and the animation written by rank 0.
    Returns the prediction: the exported array, or the world-frame one when
    animated."""
    input_keypoints = data.keypoints[args.viz_subject][args.viz_action][args.viz_camera].copy()
    ground_truth = None
    poses = data.poses_3d.get(args.viz_subject, {}).get(args.viz_action)
    if poses is not None:
        ground_truth = poses[args.viz_camera].copy()
    else:
        print("INFO: this action is unlabeled. Ground truth will not be rendered.")

    cams = [data.cameras[args.viz_subject][args.viz_camera]["intrinsic"]]
    # flip-TTA is fused into the sampler: the generator yields no flipped copy
    gen = UnchunkedGenerator(cams, [ground_truth], [input_keypoints], augment=False,
                             kps_left=data.kps_left, kps_right=data.kps_right,
                             joints_left=data.joints_left, joints_right=data.joints_right)
    evaluator = Evaluator(d3dp_eval, receptive_field=args.number_of_frames,
                          batch_size=round_up_batch(args.batch_size, mesh),
                          kps_left=data.kps_left, kps_right=data.kps_right, mesh=mesh)
    preds = evaluator.evaluate(gen, rng, noise_provider=noise_provider,
                               return_predictions=True)
    # (W, K, H, F, J, 3): the last DDIM step's first hypothesis (the
    # reference squeezes its H=1, K=1 render model, main.py:810)
    prediction = stitch_windows(preds[:, -1, 0], input_keypoints.shape[0])

    if args.viz_export is not None and process_index() == 0:
        print("Exporting joint positions to", args.viz_export)
        np.save(args.viz_export, prediction)

    if args.viz_output is not None and process_index() == 0:
        cam = data.cameras[args.viz_subject][args.viz_camera]
        if ground_truth is not None:
            trajectory = ground_truth[:, :1]
            ground_truth[:, 1:] += trajectory
            prediction = _to_world(prediction + trajectory, cam, cam["translation"])
            ground_truth = _to_world(ground_truth, cam, cam["translation"])
        else:
            prediction = _to_world(prediction, cam, 0 * cam["translation"])
            prediction[:, :, 2] -= np.min(prediction[:, :, 2])

        anim_output = {"Reconstruction": prediction}
        if ground_truth is not None and not args.viz_no_ground_truth:
            anim_output["Ground truth"] = ground_truth
        input_keypoints = image_coordinates(input_keypoints[..., :2], w=cam["res_w"],
                                            h=cam["res_h"])

        from d3dp_tpu_torch.viz.visualization import render_animation

        render_animation(input_keypoints, data.keypoints_metadata, anim_output, data.skeleton,
                         data.fps, args.viz_bitrate, cam["azimuth"], args.viz_output,
                         limit=args.viz_limit, downsample=args.viz_downsample,
                         size=args.viz_size, input_video_path=args.viz_video,
                         viewport=(cam["res_w"], cam["res_h"]),
                         input_video_skip=args.viz_skip)
    return prediction

"""Qualitative multi-hypothesis plots.

    python -m d3dp_tpu_torch.cli.main_draw -d synthetic --nolog --viz-limit 3

Counterpart of d3dp_tpu/cli/main_draw.py (reference main_draw.py:411-491,
:531-536, :730-735): evaluation only. Samples all K x H hypotheses of one
subject/action/camera, stitches the windows to the whole sequence,
reprojects every hypothesis to 2D, and plots each of the first frames in 3D
with the mean pose and the JPMA-selected pose overlaid, under
./plot/<dataset>/. Weights come from `--seed`, or from `-c`/`--evaluate`.
Runs on the card unless `--platform cpu`, on every card by default (one
process a card; rank 0 plots), as main_h36m.
"""

import os

import numpy as np
import torch

from d3dp_tpu_torch.cli.arguments import device_of, launch, parse_args
from d3dp_tpu_torch.cli.data_prep import prepare_data
from d3dp_tpu_torch.cli.main_h36m import _build_models, _generator, mesh_note
from d3dp_tpu_torch.data.generators import flip_sequence
from d3dp_tpu_torch.data.windowing import sample_windows, stitch_hypotheses, window_sequence
from d3dp_tpu_torch.device import disable_tf32, resolve_device
from d3dp_tpu_torch.geometry.camera import project_to_2d
from d3dp_tpu_torch.parallel import shard_model_params
from d3dp_tpu_torch.train.checkpoint_io import load_any


def collect_predictions(d3dp, seq_2d, kps_left, kps_right, rf, bs, generator, mesh=None):
    """Sample every window of one (Ftot, J, 2) sequence, `bs` windows a call
    -> stitched (K, H, Ftot, J, 3) numpy. `generator`: a torch.Generator on
    the sampler's device; `mesh` as in `sample_windows`."""
    w2d = window_sequence(seq_2d, rf)
    w2d_f = window_sequence(flip_sequence(seq_2d, kps_left, kps_right), rf)
    return stitch_hypotheses(sample_windows(d3dp, w2d, w2d_f, bs, generator, mesh),
                             seq_2d.shape[0])


def hypotheses(args, mesh=None):
    """Everything main_draw plots, without plotting: a dict of the
    root-zeroed hypotheses `preds` (K, H, Ftot, J, 3), their reprojections
    `pred_2d` (K, H, Ftot, J, 2), the root-zeroed ground truth `gt`, the
    input `seq_2d`, and `subject`, `action`, `camera`, `skeleton`. `mesh`:
    this rank's (`cli.arguments.launch`); every rank returns the dict."""
    device = resolve_device(device_of(args, mesh))
    if device.type == "cuda":
        disable_tf32()
    mesh_note(mesh)
    data = prepare_data(args)
    _, _, d3dp = _build_models(args, data, device)
    if args.evaluate:
        ckpt = load_any(os.path.join(args.checkpoint, args.evaluate))
        d3dp.model.load_state_dict(ckpt["model"])
    shard_model_params(d3dp.model, mesh)

    subject = args.viz_subject or args.subjects_test.split(",")[0]
    action = args.viz_action or data.actions_of(subject)[0]
    cam_idx = args.viz_camera
    seq_2d = np.asarray(data.keypoints[subject][action][cam_idx], np.float32)
    seq_3d = np.asarray(data.poses_3d[subject][action][cam_idx], np.float32)
    cam = data.cameras[subject][cam_idx]

    preds = collect_predictions(d3dp, seq_2d, data.kps_left, data.kps_right,
                                args.number_of_frames,
                                max(args.batch_size // args.number_of_frames, 1),
                                _generator(device, args.seed), mesh=mesh)
    # root-zero and reproject every hypothesis (main_draw.py:479-536)
    traj = seq_3d[:, :1].copy()
    gt = seq_3d.copy()
    gt[:, 0] = 0
    preds[..., 0, :] = 0
    K, H, Ftot, J, _ = preds.shape
    pred_abs = torch.from_numpy(preds + traj[None, None]).to(device)
    intrinsic = torch.as_tensor(np.asarray(cam["intrinsic"], np.float32)[None], device=device)
    pred_2d = project_to_2d(pred_abs.reshape(1, -1, 3), intrinsic).cpu().numpy()
    return dict(preds=preds, pred_2d=pred_2d.reshape(K, H, Ftot, J, 2), gt=gt, seq_2d=seq_2d,
                subject=subject, action=action, camera=cam_idx, skeleton=data.skeleton)


def main(argv=None):
    return launch(draw, parse_args(argv))


def draw(args, mesh=None):
    """main_draw on this process's device or rank: the hypotheses, then
    rank 0's plots. Returns the `hypotheses` dict."""
    print("Drawing...")
    h = hypotheses(args, mesh)
    if mesh is not None and mesh.rank != 0:
        return h

    from d3dp_tpu_torch.viz.visualization import draw_3d_image_select

    out_dir = os.path.join("plot", args.dataset)
    Ftot = h["gt"].shape[0]
    limit = args.viz_limit if args.viz_limit > 0 else min(Ftot, 10)
    draw_3d_image_select(h["preds"][:, :, :limit], h["gt"][:limit], h["skeleton"], 70.0,
                         h["subject"], h["action"].replace(" ", "_"), h["camera"],
                         h["seq_2d"][:limit], h["pred_2d"][:, :, :limit], out_dir=out_dir)
    print(f"Saved hypothesis plots to {out_dir}")
    return h


if __name__ == "__main__":
    main()

"""Visualization: skeleton animations and multi-hypothesis 3D plots.

The port's own copy of d3dp_tpu/viz/visualization.py (reference:
common/visualization.py): ffmpeg-based video IO with an OpenCV fallback,
the side-by-side input-video + 3D skeleton animation (mp4 through ffmpeg or,
without it, cv2.VideoWriter; gif through imagemagick or pillow), per-frame
multi-hypothesis 3D plots, and the J-Agg-selected and azimuth variants.
Host-side numpy and matplotlib only; cv2 is imported where it is used.
Callers import this module only when they draw, so the sampling paths run
without matplotlib.
"""

import os
import subprocess as sp
import warnings

import numpy as np
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
from matplotlib.animation import FuncAnimation, writers
from mpl_toolkits.mplot3d import Axes3D  # noqa: F401


# ------------------------------------------------------------- video IO
# ffprobe/ffmpeg when present (like the reference, visualization.py:17-57),
# falling back to OpenCV on ffmpeg-free hosts.
def _have_ffmpeg():
    import shutil

    return shutil.which("ffprobe") is not None


def get_resolution(filename):
    if not _have_ffmpeg():
        import cv2

        cap = cv2.VideoCapture(filename)
        wh = (int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
              int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)))
        cap.release()
        return wh
    command = ["ffprobe", "-v", "error", "-select_streams", "v:0",
               "-show_entries", "stream=width,height", "-of", "csv=p=0",
               filename]
    with sp.Popen(command, stdout=sp.PIPE, bufsize=-1) as pipe:
        for line in pipe.stdout:
            w, h = line.decode().strip().split(",")
            return int(w), int(h)


def get_fps(filename):
    if not _have_ffmpeg():
        import cv2

        cap = cv2.VideoCapture(filename)
        fps = cap.get(cv2.CAP_PROP_FPS)
        cap.release()
        return fps
    command = ["ffprobe", "-v", "error", "-select_streams", "v:0",
               "-show_entries", "stream=r_frame_rate", "-of", "csv=p=0",
               filename]
    with sp.Popen(command, stdout=sp.PIPE, bufsize=-1) as pipe:
        for line in pipe.stdout:
            a, b = line.decode().strip().split("/")
            return int(a) / int(b)


def read_video(filename, skip=0, limit=-1):
    """Yield RGB frames (H, W, 3) uint8."""
    if not _have_ffmpeg():
        import cv2

        cap = cv2.VideoCapture(filename)
        i = 0
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            i += 1
            if i > limit > -1:
                break
            if i > skip:
                yield cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
        cap.release()
        return
    w, h = get_resolution(filename)
    command = ["ffmpeg", "-i", filename, "-f", "image2pipe", "-pix_fmt",
               "rgb24", "-vsync", "0", "-vcodec", "rawvideo", "-"]
    i = 0
    with sp.Popen(command, stdout=sp.PIPE, bufsize=-1) as pipe:
        while True:
            data = pipe.stdout.read(w * h * 3)
            if not data:
                break
            i += 1
            if i > limit > -1:
                break
            if i > skip:
                yield np.frombuffer(data, dtype="uint8").reshape((h, w, 3))


def downsample_tensor(X, factor):
    length = X.shape[0] // factor * factor
    return np.mean(X[:length].reshape(-1, factor, *X.shape[1:]), axis=1)


# --------------------------------------------------------- skeleton helpers
def _skeleton_segments(skeleton):
    """[(joint, parent, is_right), ...] for drawable bones."""
    parents = skeleton.parents()
    right = set(skeleton.joints_right())
    return [(j, p, j in right) for j, p in enumerate(parents) if p != -1]


def _setup_3d_axis(ax, azim, radius=1.7, title=None):
    ax.view_init(elev=15.0, azim=azim)
    ax.set_xlim3d([-radius / 2, radius / 2])
    ax.set_zlim3d([0, radius])
    ax.set_ylim3d([-radius / 2, radius / 2])
    try:
        ax.set_aspect("equal")
    except NotImplementedError:
        ax.set_aspect("auto")
    ax.set_xticklabels([])
    ax.set_yticklabels([])
    ax.set_zticklabels([])
    try:
        ax.dist = 7.5
    except AttributeError:
        pass
    if title:
        ax.set_title(title)


def _plot_pose_3d(ax, pose, skeleton, color_right="black", color_left="red",
                  alpha=1.0, lw=2):
    lines = []
    for j, p, is_right in _skeleton_segments(skeleton):
        col = color_right if is_right else color_left
        (ln,) = ax.plot(
            [pose[j, 0], pose[p, 0]], [pose[j, 1], pose[p, 1]],
            [pose[j, 2], pose[p, 2]], zdir="z", c=col, alpha=alpha, lw=lw)
        lines.append(ln)
    return lines


# ------------------------------------------------------------ animation
def render_animation(keypoints, keypoints_metadata, poses, skeleton, fps,
                     bitrate, azim, output, viewport, limit=-1, downsample=1,
                     size=6, input_video_path=None, input_video_skip=0):
    """Side-by-side input (2D keypoints / video) + one 3D panel per entry of
    `poses` (dict name -> (T, J, 3)), exported as .mp4 or .gif.
    (reference: common/visualization.py:486-668)
    """
    plt.ioff()
    n_panels = 1 + len(poses)
    fig = plt.figure(figsize=(size * n_panels, size))
    ax_in = fig.add_subplot(1, n_panels, 1)
    ax_in.get_xaxis().set_visible(False)
    ax_in.get_yaxis().set_visible(False)
    ax_in.set_axis_off()
    ax_in.set_title("Input")

    ax_3d, trajectories = [], []
    for idx, (title, data) in enumerate(poses.items()):
        ax = fig.add_subplot(1, n_panels, idx + 2, projection="3d")
        _setup_3d_axis(ax, azim, title=title)
        ax_3d.append(ax)
        trajectories.append(data[:, 0, [0, 1]])
    poses_list = list(poses.values())

    if input_video_path is None:
        # black background of the viewport size
        all_frames = np.zeros(
            (keypoints.shape[0], viewport[1], viewport[0]), dtype="uint8")
    else:
        all_frames = list(read_video(
            input_video_path, skip=input_video_skip,
            limit=limit if limit != -1 else -1))
        all_frames = np.stack(all_frames) if all_frames else np.zeros(
            (keypoints.shape[0], viewport[1], viewport[0], 3), dtype="uint8")

    if downsample > 1:
        keypoints = downsample_tensor(keypoints, downsample)
        all_frames = downsample_tensor(
            np.asarray(all_frames, dtype="float32"), downsample
        ).astype("uint8")
        poses_list = [downsample_tensor(p, downsample) for p in poses_list]
        trajectories = [downsample_tensor(t, downsample) for t in trajectories]
        fps /= downsample

    n_frames = keypoints.shape[0] if limit < 1 else min(limit, keypoints.shape[0])

    initialized = False
    image = None
    lines_3d = [[] for _ in ax_3d]
    points = None

    kp_colors = ["red", "black"]
    joints_right_2d = (keypoints_metadata or {}).get(
        "keypoints_symmetry", ([], []))[1]
    colors_2d = np.full(keypoints.shape[1], kp_colors[0], dtype=object)
    colors_2d[list(joints_right_2d)] = kp_colors[1]

    def update_video(i):
        nonlocal initialized, image, points
        for n, ax in enumerate(ax_3d):
            traj = trajectories[n]
            ax.set_xlim3d([-1.7 / 2 + traj[i, 0], 1.7 / 2 + traj[i, 0]])
            ax.set_ylim3d([-1.7 / 2 + traj[i, 1], 1.7 / 2 + traj[i, 1]])

        frame = all_frames[min(i, len(all_frames) - 1)]
        if not initialized:
            image = ax_in.imshow(frame, aspect="equal")
            points = ax_in.scatter(
                *keypoints[i].T, 10, color=colors_2d, edgecolors="white",
                zorder=10)
            for n, ax in enumerate(ax_3d):
                lines_3d[n] = _plot_pose_3d(ax, poses_list[n][i], skeleton)
            initialized = True
        else:
            image.set_data(frame)
            points.set_offsets(keypoints[i])
            for n, ax in enumerate(ax_3d):
                pose = poses_list[n][i]
                for ln, (j, p, _) in zip(lines_3d[n],
                                         _skeleton_segments(skeleton)):
                    ln.set_xdata([pose[j, 0], pose[p, 0]])
                    ln.set_ydata([pose[j, 1], pose[p, 1]])
                    ln.set_3d_properties([pose[j, 2], pose[p, 2]], zdir="z")

    with warnings.catch_warnings():
        # 3D axes reject tight_layout with a UserWarning; the reference uses
        # the same call and accepts the default layout there too
        warnings.simplefilter("ignore", UserWarning)
        fig.tight_layout()
    anim = FuncAnimation(
        fig, update_video, frames=np.arange(0, n_frames),
        interval=1000 / fps, repeat=False)
    if output.endswith(".mp4"):
        if _have_ffmpeg():
            Writer = writers["ffmpeg"]
            writer = Writer(fps=fps, metadata={}, bitrate=bitrate)
            anim.save(output, writer=writer)
        else:
            # ffmpeg-free mp4: rasterize each animation frame with Agg and
            # stream it into cv2.VideoWriter (reference hard-requires the
            # ffmpeg matplotlib writer, visualization.py:644-650)
            _save_mp4_cv2(fig, update_video, n_frames, fps, output)
    elif output.endswith(".gif"):
        try:
            anim.save(output, dpi=80, writer="imagemagick")
        except (ValueError, RuntimeError):
            anim.save(output, dpi=80, writer="pillow")
    else:
        raise ValueError(
            "Unsupported output format (only .mp4 and .gif are supported)")
    plt.close(fig)


def _save_mp4_cv2(fig, update_fn, n_frames, fps, output):
    """Write an animation as mp4 through cv2.VideoWriter: draw each frame on
    the figure's Agg canvas and encode the RGB buffer (BGR for cv2)."""
    import cv2

    size = None
    writer = None
    try:
        for i in range(n_frames):
            update_fn(i)
            fig.canvas.draw()
            buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
            if writer is None:
                size = (buf.shape[1], buf.shape[0])
                writer = cv2.VideoWriter(
                    output, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
                if not writer.isOpened():
                    raise RuntimeError(
                        f"cv2.VideoWriter could not open {output}")
            writer.write(cv2.cvtColor(buf, cv2.COLOR_RGB2BGR))
    finally:
        if writer is not None:
            writer.release()


# --------------------------------------------- multi-hypothesis 3D figures
def _save_hypothesis_figure(path, hyp_poses, extra, skeleton, azim, radius=1.7):
    """One 3D figure: faint hypothesis skeletons + optional named overlays
    {label: (pose, color)}. Axes are centred on the first overlay (GT)."""
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(1, 1, 1, projection="3d")
    _setup_3d_axis(ax, azim, radius=radius)
    if extra:
        center = next(iter(extra.values()))[0].mean(axis=0)
        ax.set_xlim3d([center[0] - radius / 2, center[0] + radius / 2])
        ax.set_ylim3d([center[1] - radius / 2, center[1] + radius / 2])
        ax.set_zlim3d([center[2] - radius / 2, center[2] + radius / 2])
    for pose in hyp_poses:
        _plot_pose_3d(ax, pose, skeleton, color_right="gray",
                      color_left="lightcoral", alpha=0.35, lw=1)
    for label, (pose, color) in (extra or {}).items():
        _plot_pose_3d(ax, pose, skeleton, color_right=color, color_left=color,
                      alpha=1.0, lw=2)
    with warnings.catch_warnings():
        # 3D axes reject tight_layout with a UserWarning; the reference uses
        # the same call and accepts the default layout there too
        warnings.simplefilter("ignore", UserWarning)
        fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def draw_3d_image(pred_all, gt_all, skeleton, azim, sub, act, cam,
                  out_dir="./plot"):
    """Per-frame multi-hypothesis plots: all H hypotheses + GT.

    pred_all: (K, H, T, J, 3); gt_all: (T, J, 3).
    (reference: common/visualization.py:136-213)
    """
    out = os.path.join(out_dir, f"{sub}_{act}_{cam}")
    os.makedirs(out, exist_ok=True)
    K, H, T = pred_all.shape[:3]
    for t in range(T):
        _save_hypothesis_figure(
            os.path.join(out, f"frame_{t:04d}.png"),
            [pred_all[-1, h, t] for h in range(H)],
            {"GT": (gt_all[t], "blue")},
            skeleton, azim)


def draw_3d_image_select(pred_all, gt_all, skeleton, azim, sub, act, cam,
                         gt_2d, pred_2d, out_dir="./plot"):
    """Hypotheses + mean pose (green) + J-Agg/JPMA-selected pose (red) + GT.

    pred_all: (K, H, T, J, 3); pred_2d: (K, H, T, J, 2); gt_2d: (T, J, 2).
    (reference: common/visualization.py:215-325)
    """
    out = os.path.join(out_dir, f"{sub}_{act}_{cam}")
    os.makedirs(out, exist_ok=True)
    K, H, T = pred_all.shape[:3]
    err2d = np.linalg.norm(pred_2d[-1] - gt_2d[None], axis=-1)  # (H,T,J)
    sel = np.argmin(err2d, axis=0)  # (T,J)
    for t in range(T):
        jpma = np.take_along_axis(
            pred_all[-1, :, t], sel[t][None, :, None], axis=0)[0]
        _save_hypothesis_figure(
            os.path.join(out, f"frame_{t:04d}.png"),
            [pred_all[-1, h, t] for h in range(H)],
            {
                "GT": (gt_all[t], "blue"),
                "Mean": (pred_all[-1, :, t].mean(axis=0), "green"),
                "JPMA": (jpma, "red"),
            },
            skeleton, azim)


def _azim_frame_figure(pred_khj, gt_j, skeleton, azim, t, joint_overlays=None):
    """One azimuth-view figure in the reference's style: root-centred
    millimetre coordinates, fixed 1000/1500 mm axis radii, elev 15, every
    hypothesis of timestep `t` dashed + GT in blue. `joint_overlays`
    optionally adds per-joint (select_idx, min_idx) scatter + index labels.
    (reference: common/visualization.py:349-400, :430-470)"""
    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    xy_radius, radius = 1000.0, 1500.0
    ax.view_init(elev=15.0, azim=azim)
    ax.set_xlim3d([-xy_radius / 2, xy_radius / 2])
    ax.set_zlim3d([-radius / 2, radius / 2])
    ax.set_ylim3d([-xy_radius / 2, xy_radius / 2])
    ax.set_xticklabels([])
    ax.set_yticklabels([])
    ax.set_zticklabels([])
    ax.set_title("timestep %d" % t)

    pred_t = pred_khj[t]  # (H, J, 3), mm, root-centred
    if joint_overlays is not None:
        sel_t, min_t = joint_overlays  # each (J,) hypothesis indices
        for jj in range(pred_t.shape[1]):
            si, mi = int(sel_t[jj]), int(min_t[jj])
            ax.scatter(pred_t[si, jj, 0], pred_t[si, jj, 1],
                       pred_t[si, jj, 2], s=0.5, c="g", zorder=10)
            ax.scatter(pred_t[mi, jj, 0], pred_t[mi, jj, 1],
                       pred_t[mi, jj, 2], s=2, c="r", zorder=4)
            ax.text(x=pred_t[mi, jj, 0] + 10, y=pred_t[mi, jj, 1],
                    z=pred_t[mi, jj, 2] + 20, s=str(mi), color="r",
                    fontsize=3)
            ax.text(x=pred_t[si, jj, 0] - 10, y=pred_t[si, jj, 1],
                    z=pred_t[si, jj, 2] + 20, s=str(si), color="g",
                    fontsize=3)

    for j, j_parent in enumerate(skeleton.parents()):
        if j_parent == -1:
            continue
        for h in range(pred_t.shape[0]):
            ax.plot([pred_t[h, j, 0], pred_t[h, j_parent, 0]],
                    [pred_t[h, j, 1], pred_t[h, j_parent, 1]],
                    [pred_t[h, j, 2], pred_t[h, j_parent, 2]],
                    zdir="z", linestyle="--", linewidth=0.5)
        ax.plot([gt_j[j, 0], gt_j[j_parent, 0]],
                [gt_j[j, 1], gt_j[j_parent, 1]],
                [gt_j[j, 2], gt_j[j_parent, 2]],
                zdir="z", c="blue", linewidth=0.9)
    return fig


def _azim_centred_mm(pred_all, gt_all, frame):
    """Root-centred mm poses of one video frame: ((K,H,J,3), (J,3))."""
    pred = np.asarray(pred_all[:, :, frame], dtype=np.float64)
    gt = np.asarray(gt_all[frame], dtype=np.float64)
    pred = (pred - pred[:, :, 0:1]) * 1000.0
    gt = (gt - gt[0:1]) * 1000.0
    return pred, gt


def draw_3d_image_azim(pred_all, gt_all, skeleton, azim, sub, act, cam,
                       azim_off=0, out_dir="./plot/h36m", frame_stride=4):
    """Per-frame 3D renders at view azimuth `azim + azim_off` — calling with
    a range of azim_off values produces the reference's azimuth sweep.
    Renders every `frame_stride`-th video frame at the FINAL diffusion
    timestep only. pred_all: (K,H,T,J,3) metres; gt_all: (T,J,3).
    (reference: common/visualization.py:327-400)"""
    os.makedirs(out_dir, exist_ok=True)
    K = pred_all.shape[0]
    for frame in range(gt_all.shape[0]):
        if frame % frame_stride != 0:
            continue
        pred, gt = _azim_centred_mm(pred_all, gt_all, frame)
        t = K - 1
        fig = _azim_frame_figure(pred, gt, skeleton, azim + azim_off, t)
        fig.savefig(
            os.path.join(out_dir, "%s_%s_%d_frame%d_t%d_azim%d.png"
                         % (sub, act, cam, frame, t, azim_off)),
            bbox_inches="tight", pad_inches=0.0, dpi=300)
        plt.close(fig)


def draw_3d_image_azim_ind(pred_all, gt_all, skeleton, azim, sub, act, cam,
                           azim_off=0, select_ind=None, min_ind=None,
                           out_dir="./plot/h36m", frame_stride=10,
                           timestep_stride=2):
    """Azimuth view with explicit per-joint hypothesis selections: for every
    `frame_stride`-th frame and every `timestep_stride`-th diffusion
    timestep, scatter the JPMA-selected (green) and oracle-best (red)
    hypothesis per joint, labeled with their hypothesis indices.
    select_ind/min_ind: (K, T, J) [or (K, 1, T, J)] int hypothesis indices.
    (reference: common/visualization.py:402-484)"""
    os.makedirs(out_dir, exist_ok=True)
    K = pred_all.shape[0]
    select_ind = np.asarray(select_ind)
    min_ind = np.asarray(min_ind)
    if select_ind.ndim == 4:  # reference layout (K, B=1, T, J)
        select_ind = select_ind[:, 0]
    if min_ind.ndim == 4:
        min_ind = min_ind[:, 0]
    for frame in range(gt_all.shape[0]):
        if frame % frame_stride != 0:
            continue
        pred, gt = _azim_centred_mm(pred_all, gt_all, frame)
        for t in range(0, K, timestep_stride):
            fig = _azim_frame_figure(
                pred, gt, skeleton, azim + azim_off, t,
                joint_overlays=(select_ind[t, frame], min_ind[t, frame]))
            fig.savefig(
                os.path.join(out_dir, "%s_%s_%d_frame%d_t%d_azim%d.png"
                             % (sub, act, cam, frame, t, azim_off)),
                bbox_inches="tight", pad_inches=0.0, dpi=300)
            plt.close(fig)

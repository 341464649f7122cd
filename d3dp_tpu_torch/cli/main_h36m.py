"""Human3.6M entry point: train and evaluate.

    python -m d3dp_tpu_torch.cli.main_h36m -d synthetic --nolog ...

Counterpart of d3dp_tpu/cli/main_h36m.py (reference main.py: train loop
:304-592, evaluate :596-794, action-wise loop :952-1046) on one device:
the same flags (cli/arguments.py), log-file names and line formats, and
checkpoints with the original's payload (train/checkpoint_io.py). Runs on
the card unless `--platform cpu`.
"""

import copy
import os
import sys
import zlib
from datetime import datetime
from time import time

import numpy as np
import torch

from d3dp_tpu_torch.cli.arguments import device_of, parse_args
from d3dp_tpu_torch.cli.data_prep import fetch, prepare_data
from d3dp_tpu_torch.data.generators import ChunkedGenerator, UnchunkedGenerator
from d3dp_tpu_torch.data.prefetch import Prefetcher
from d3dp_tpu_torch.device import disable_tf32, resolve_device
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.eval import MODES, Evaluator
from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig
from d3dp_tpu_torch.train.checkpoint_io import latest_checkpoint, load_any, save_checkpoint
from d3dp_tpu_torch.train.state import get_lr, make_optimizer, make_train_step, set_lr
from d3dp_tpu_torch.utils.logging import Logger, TensorBoardWriter
from d3dp_tpu_torch.utils.profiling import trace as profiler_trace


def _build_models(args, data, device=None):
    """Train-config, validation-config (H=1, K=1) and eval-config D3DPs over
    one MixSTE2 (reference: 3 D3DP instances sharing weights, main.py:228-230).
    The training D3DP draws DropPath 0.1; the other two sample on the eval
    path at `--fuse-level`, which applies no DropPath. DDIM feature reuse
    (`--ddim-reuse`, `-tap`, `-adaptive`) applies to the eval D3DP only."""
    cfg = MixSTEConfig(
        num_frames=args.number_of_frames,
        num_joints=data.num_joints,
        embed_dim=args.cs,
        depth=args.dep,
        drop_path_rate=0.1,
        dtype=torch.bfloat16 if args.dtype == "bfloat16" else torch.float32,
        fuse_level=args.fuse_level,
    )
    model = MixSTE2(cfg, device, seed=args.seed)
    common = dict(
        model=cfg,
        timesteps=args.timestep,
        scale=args.scale,
        joints_left=tuple(data.joints_left),
        joints_right=tuple(data.joints_right),
        flip_tta=args.test_time_augmentation,
    )
    d3dp_train = D3DP(D3DPConfig(**common), model=model)
    d3dp_valid = D3DP(D3DPConfig(num_proposals=1, sampling_timesteps=1, **common), model=model)
    d3dp_eval = D3DP(D3DPConfig(num_proposals=args.num_proposals,
                                sampling_timesteps=args.sampling_timesteps,
                                reuse_interval=max(args.ddim_reuse, 1),
                                reuse_tap=max(1, min(args.ddim_reuse_tap, args.dep)),
                                reuse_tau=args.ddim_reuse_adaptive, **common),
                     model=model)
    return d3dp_train, d3dp_valid, d3dp_eval


def _log_path(args):
    return os.path.join(
        args.checkpoint,
        f"h36m_test_log_H{args.num_proposals}_K{args.sampling_timesteps}.txt",
    )


def _print_and_log(f, msg):
    print(msg)
    if f is not None:
        f.write(msg + "\n")


def report_result(args, result, action=None):
    """Per-action report, reference format (main.py:745-789)."""
    with open(_log_path(args), "a") as f:
        if action is None:
            print("----------")
        else:
            _print_and_log(f, "----" + action + "----")
        e1 = result.averages_mm()
        e2 = result.averages_p2_mm() if args.p2 else None
        K = len(e1["P_Best"])
        for ii in range(K):
            for mode in MODES:
                _print_and_log(
                    f, "step %d : Protocol #1 Error (MPJPE) %s: %f mm" % (ii, mode, e1[mode][ii]))
            if e2 is not None:
                for mode in MODES:
                    _print_and_log(
                        f,
                        "step %d : Protocol #2 Error (MPJPE) %s: %f mm" % (ii, mode, e2[mode][ii]))
        _print_and_log(f, "----------")


def _generator(device, seed, salt=0):
    """A torch.Generator on `device` seeded from (seed, salt): the port's
    counterpart of the JAX package's split / fold_in keys."""
    return torch.Generator(device=device).manual_seed((seed << 32) + salt)


def run_evaluation(args, data, d3dp_eval, noise_provider=None):
    """Action-wise evaluation. (reference: main.py:901-1046)

    Each action samples from its own generator, seeded from `--seed` and a
    stable hash of the action name. `noise_provider` (optional) is forwarded
    to Evaluator.evaluate and replaces the sampler's draws (parity tests).
    Returns {action: EvalResult}, or {subject: {action: EvalResult}} with
    --by-subject.
    """
    subjects_test = args.subjects_test.split(",")
    action_filter = None if args.actions == "*" else args.actions.split(",")

    all_actions = {}
    all_actions_by_subject = {}
    for subject in subjects_test:
        all_actions_by_subject[subject] = {}
        for action in data.actions_of(subject):
            action_name = action.split(" ")[0]
            all_actions.setdefault(action_name, []).append((subject, action))
            all_actions_by_subject[subject].setdefault(action_name, []).append(
                (subject, action))

    evaluator = Evaluator(
        d3dp_eval,
        receptive_field=args.number_of_frames,
        batch_size=args.eval_batch_size or args.batch_size,
        kps_left=data.kps_left,
        kps_right=data.kps_right,
        p2=args.p2,
        p2_device=args.p2_device,
        quickdebug=args.debug,
    )

    def fetch_actions(actions):
        out_p3, out_p2, out_cam = [], [], []
        for subject, action in actions:
            for p in data.keypoints[subject][action]:
                out_p2.append(p)
            poses_3d = data.poses_3d[subject][action]
            if len(poses_3d) != len(data.keypoints[subject][action]):
                raise ValueError(f"{subject} {action}: camera count mismatch")
            for p in poses_3d:
                out_p3.append(p)
            for cam in data.cameras[subject]:
                if "intrinsic" in cam:
                    out_cam.append(cam["intrinsic"])
        if args.downsample > 1:
            s = args.downsample
            out_p2 = [p[::s] for p in out_p2]
            out_p3 = [p[::s] for p in out_p3]
        return out_cam, out_p3, out_p2

    def eval_actions(actions_map):
        per_action = {}
        for action_key in actions_map:
            if action_filter is not None and not any(
                    action_key.startswith(a) for a in action_filter):
                continue
            cams, p3, p2 = fetch_actions(actions_map[action_key])
            # flip-TTA is fused inside the sampler, so the generator yields
            # no flipped duplicate (unlike the reference's set_augment path)
            gen = UnchunkedGenerator(cams, p3, p2)
            # stable per-action seed (hash() is salted per process)
            rng = _generator(d3dp_eval.device, args.seed, zlib.crc32(action_key.encode()) % 2**31)
            if args.profile and not per_action:  # trace the first action
                with profiler_trace(args.profile):
                    result = evaluator.evaluate(gen, rng, noise_provider=noise_provider)
                    # EvalResult defers the device reads: finish inside the trace
                    result.averages_mm()
                print(f"profiler trace written to {args.profile}")
            else:
                result = evaluator.evaluate(gen, rng, noise_provider=noise_provider)
            report_result(args, result, action_key)
            per_action[action_key] = result

        # action-wise averages (main.py:998-1046)
        with open(_log_path(args), "a") as f:
            avg = {m: np.mean([r.averages_mm()[m] for r in per_action.values()], axis=0)
                   for m in MODES}
            K = len(avg["P_Best"])
            for ii in range(K):
                for m in MODES:
                    _print_and_log(
                        f, "step %d Protocol #1   (MPJPE) action-wise average %s: %f mm"
                        % (ii, m, avg[m][ii]))
            if args.p2:
                avg2 = {m: np.mean([r.averages_p2_mm()[m] for r in per_action.values()], axis=0)
                        for m in MODES}
                for ii in range(K):
                    for m in MODES:
                        _print_and_log(
                            f, "step %d Protocol #2   (MPJPE) action-wise average %s: %f mm"
                            % (ii, m, avg2[m][ii]))
        return per_action

    if not args.by_subject:
        return eval_actions(all_actions)
    results = {}
    for subject in all_actions_by_subject:
        print("Evaluating on subject", subject)
        results[subject] = eval_actions(all_actions_by_subject[subject])
        print("")
    return results


def _resume(args, ckpt, model, optimizer, train_generator, lr, min_loss):
    """Full resume from a `load_any` checkpoint (reference main.py:330-345):
    the weights; the AdamW state and the training generator's random state
    where the checkpoint has an optimizer state; its lr unless --coverlr;
    its min_loss. Returns (epoch, lr, min_loss)."""
    model.load_state_dict(ckpt["model"])
    if ckpt.get("optimizer") is not None:
        optimizer.load_state_dict(ckpt["optimizer"])
        if ckpt.get("random_state") is not None:
            train_generator.set_random_state(ckpt["random_state"])
    else:
        print("WARNING: this checkpoint does not contain an optimizer "
              "state. The optimizer will be reinitialized.")
    if not args.coverlr and ckpt.get("lr") is not None:
        lr = ckpt["lr"]
    set_lr(optimizer, lr)
    if ckpt.get("min_loss") is not None:
        min_loss = ckpt["min_loss"]
    return ckpt["epoch"], lr, min_loss


def run_training(args, data, d3dp_train, d3dp_valid, writer, resume_ckpt=None):
    """Training loop (reference: main.py:304-592): ChunkedGenerator ->
    Prefetcher -> train step, light validation (P-Best at H=1, K=1), lr
    decay, and the epoch and best checkpoints. Returns the optimizer."""
    model = d3dp_train.model
    dev = d3dp_train.device
    subjects_train = args.subjects_train.split(",")
    subjects_test = args.subjects_test.split(",")
    action_filter = None if args.actions == "*" else args.actions.split(",")

    cams_train, poses_train, poses_train_2d = fetch(
        data, subjects_train, action_filter, subset=args.subset, downsample=args.downsample)
    cams_valid, poses_valid, poses_valid_2d = fetch(
        data, subjects_test, action_filter, downsample=args.downsample)

    lr = args.learning_rate
    optimizer = make_optimizer(model.parameters(), lr, weight_decay=0.1)
    step = make_train_step(d3dp_train, optimizer)

    train_generator = ChunkedGenerator(
        args.batch_size // args.stride, cams_train, poses_train, poses_train_2d,
        args.number_of_frames, shuffle=True, augment=args.data_augmentation,
        kps_left=data.kps_left, kps_right=data.kps_right,
        joints_left=data.joints_left, joints_right=data.joints_right,
        pad_last=True,
    )
    test_generator = UnchunkedGenerator(cams_valid, poses_valid, poses_valid_2d)
    print(f"INFO: Training on {sum(p.shape[0] for p in poses_train_2d)} frames")
    print(f"INFO: Testing on {test_generator.num_frames()} frames")

    validator = Evaluator(
        d3dp_valid, receptive_field=args.number_of_frames,
        batch_size=args.eval_batch_size or args.batch_size,
        kps_left=data.kps_left, kps_right=data.kps_right, quickdebug=args.debug, light=True)

    epoch = 0
    min_loss = args.min_loss
    train_curve, valid_curve = [], []
    # the step's t, noise and DropPath draws, and validation's sampling noise
    g_train = _generator(dev, args.seed, 1)
    g_valid = _generator(dev, args.seed, 2)

    if args.resume:
        ckpt = resume_ckpt or load_any(os.path.join(args.checkpoint, args.resume))
        epoch, lr, min_loss = _resume(args, ckpt, model, optimizer, train_generator, lr,
                                      min_loss)

    print("** Note: reported losses are averaged over all frames.")
    log_path = os.path.join(args.checkpoint, "training_log.txt")

    while epoch < args.epochs:
        start_time = time()
        profiling = bool(args.profile) and not train_curve  # the first epoch of this run
        # losses stay on the device until the epoch ends: reading each one
        # would make the host wait for every step
        step_losses, step_weights = [], []
        with profiler_trace(args.profile, enabled=profiling):
            for _, b3, b2, w in Prefetcher(train_generator.next_epoch(), depth=2):
                step_losses.append(step(b2, b3, w, generator=g_train))
                step_weights.append(int(w.sum()) * args.number_of_frames)
                if args.debug:
                    break
        if profiling:
            print(f"profiler trace written to {args.profile}")
        losses_np = torch.stack(step_losses).double().cpu().numpy()
        weights_np = np.asarray(step_weights, dtype=np.float64)
        train_loss = float((losses_np * weights_np).sum()) / float(weights_np.sum())

        valid_pbest = None
        if not args.no_eval:
            vres = validator.evaluate(test_generator, g_valid)
            valid_pbest = float(vres.averages_mm()["P_Best"][0])

        elapsed = (time() - start_time) / 60
        lr = get_lr(optimizer)
        if valid_pbest is None:
            msg = "[%d] time %.2f lr %f 3d_train %f" % (
                epoch + 1, elapsed, lr, train_loss * 1000)
        else:
            msg = "[%d] time %.2f lr %f 3d_train %f 3d_pos_valid %f" % (
                epoch + 1, elapsed, lr, train_loss * 1000, valid_pbest)
        print(msg)
        with open(log_path, "a") as f:
            f.write(msg + "\n")
        if writer is not None:
            writer.add_scalar("Loss/3d training loss", train_loss * 1000, epoch + 1)
            if valid_pbest is not None:
                writer.add_scalar("Loss/3d validation loss", valid_pbest, epoch + 1)
            writer.add_scalar("Parameters/learning rate", lr, epoch + 1)
            writer.add_scalar("Parameters/training time per epoch", elapsed, epoch + 1)

        # exponential lr decay (main.py:529-531)
        lr *= args.lr_decay
        set_lr(optimizer, lr)
        epoch += 1

        def _save(path):
            save_checkpoint(path, epoch=epoch, lr=lr, model=model, optimizer=optimizer,
                            generator_random_state=copy.deepcopy(train_generator.random_state()),
                            min_loss=min_loss)

        if epoch % args.checkpoint_frequency == 0:
            chk_path = os.path.join(args.checkpoint, f"epoch_{epoch}.ckpt")
            print("Saving checkpoint to", chk_path)
            _save(chk_path)

        if valid_pbest is not None and valid_pbest < min_loss:
            min_loss = valid_pbest
            print("save best checkpoint")
            _save(os.path.join(args.checkpoint, "best_epoch.ckpt"))
            with open(log_path, "a") as f:
                f.write("best epoch\n")

        train_curve.append(train_loss * 1000)
        if valid_pbest is not None:
            valid_curve.append(valid_pbest)
        if args.export_training_curves and epoch > 3:
            _plot_curves(args, epoch, train_curve, valid_curve)
    return optimizer


def _plot_curves(args, epoch, train_curve, valid_curve):
    """Loss-curve PNG (reference main.py:575-592)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure()
    epoch_x = np.arange(3, len(train_curve)) + 1
    plt.plot(epoch_x, train_curve[3:], "--", color="C0")
    if len(valid_curve) > 3:
        plt.plot(epoch_x[: len(valid_curve) - 3], valid_curve[3:], color="C1")
    plt.legend(["3d train", "3d valid (eval)"])
    plt.ylabel("MPJPE (mm)")
    plt.xlabel("Epoch")
    plt.xlim((3, epoch))
    plt.savefig(os.path.join(args.checkpoint, "loss_3d.png"))
    plt.close("all")


def run_with_args(args):
    device = resolve_device(device_of(args))
    if device.type == "cuda":
        disable_tf32()
    description = "Evaluate!" if args.evaluate else "Train!"
    timestamp = "{0:%Y%m%dT%H-%M-%S}".format(datetime.now())

    writer = None
    if not args.nolog:
        logdir = args.log + "_" + timestamp
        os.makedirs(logdir, exist_ok=True)
        writer = TensorBoardWriter(logdir)
        writer.add_text("description", description)
        writer.add_text("command", "python " + " ".join(sys.argv))
        sys.stdout = Logger(os.path.join(logdir, "logging.log"))
    print(description)
    print("Torch device:", device,
          torch.cuda.get_device_name(device) if device.type == "cuda" else "")

    if args.checkpoint == "":
        args.checkpoint = args.log + "_" + timestamp
    os.makedirs(args.checkpoint, exist_ok=True)

    print("Loading dataset...")
    data = prepare_data(args)

    d3dp_train, d3dp_valid, d3dp_eval = _build_models(args, data, device)
    model = d3dp_train.model
    n_params = sum(p.numel() for p in model.parameters())
    print("INFO: Trainable parameter count:", n_params / 1e6, "Million")
    print("INFO: Receptive field: {} frames".format(args.number_of_frames))

    if args.resume in ("auto", "latest"):
        found = latest_checkpoint(args.checkpoint)
        args.resume = os.path.basename(found) if found else ""
        print("Auto-resume:", args.resume or "(no checkpoint found)")

    loaded_ckpt = None
    if args.resume or args.evaluate:
        chk_filename = os.path.join(args.checkpoint, args.resume or args.evaluate)
        print("Loading checkpoint", chk_filename)
        loaded_ckpt = load_any(chk_filename)
        print("This model was trained for {} epochs".format(loaded_ckpt.get("epoch")))
        model.load_state_dict(loaded_ckpt["model"])

    try:
        if args.evaluate:
            print("Evaluating...")
            return run_evaluation(args, data, d3dp_eval)
        return run_training(args, data, d3dp_train, d3dp_valid, writer, resume_ckpt=loaded_ckpt)
    finally:
        if writer is not None:
            writer.close()


def main(argv=None):
    return run_with_args(parse_args(argv))


if __name__ == "__main__":
    main()

"""MPI-INF-3DHP entry point: train, and evaluate with the pose-selection
exports and the Python PCK/AUC stage.

    python -m d3dp_tpu_torch.cli.main_3dhp -d synthetic --nolog ...

Counterpart of d3dp_tpu/cli/main_3dhp.py (reference main_3dhp.py), on
every card by default, one process a card, as main_h36m: the H36M command
line's flags (cli/arguments.py), mm-scaled
diffusion (unit_scale 1000), pelvis(14)-rooted data, valid-frame-masked
metrics, per-TS cameras and the inference_data_<mode>.mat exports
(main_3dhp.py:903-912), then the PCK/AUC tables
(`metrics.pck_auc.evaluate_3dhp_mat`) when 3dhp_test/TS*/annot_data.mat is
present. Runs on the card unless `--platform cpu`.
"""

import os
import sys
from datetime import datetime
from time import time

import numpy as np
import torch

from d3dp_tpu_torch.cli.arguments import device_of, launch, parse_args
from d3dp_tpu_torch.cli.main_h36m import (
    _generator,
    _log_file,
    _resume,
    checkpoint_saver,
    eval_batch_size,
    mesh_note,
)
from d3dp_tpu_torch.data.generators import ChunkedGenerator, UnchunkedGenerator
from d3dp_tpu_torch.data.mpi3dhp import (
    KPS_LEFT,
    KPS_RIGHT,
    ROOT_JOINT,
    load_test,
    load_train,
    make_synthetic,
)
from d3dp_tpu_torch.data.prefetch import Prefetcher
from d3dp_tpu_torch.device import disable_tf32, resolve_device
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.eval.evaluator_3dhp import MODES, Evaluator3DHP
from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig
from d3dp_tpu_torch.parallel import (
    process_index,
    round_up_batch,
    shard_batch_fn,
    shard_model_params,
)
from d3dp_tpu_torch.train.checkpoint_io import latest_checkpoint, load_any, wait_for_checkpoints
from d3dp_tpu_torch.train.state import get_lr, make_optimizer, make_train_step, set_lr
from d3dp_tpu_torch.utils.logging import Logger, TensorBoardWriter


def _build_models(args, device=None):
    """Train-config, validation-config (H=1, K=1) and eval-config D3DPs over
    one MixSTE2 in millimetres (unit_scale 1000), with the 3DHP symmetry
    lists; fuse level and DDIM feature reuse as in main_h36m._build_models."""
    cfg = MixSTEConfig(
        num_frames=args.number_of_frames,
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
        joints_left=tuple(KPS_LEFT),
        joints_right=tuple(KPS_RIGHT),
        flip_tta=args.test_time_augmentation,
        unit_scale=1000.0,  # 3DHP data is in millimetres
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


def _load_data(args):
    """(poses_3d_train, poses_2d_train, poses_3d_test, poses_2d_test, valid)."""
    if args.dataset == "synthetic":
        return make_synthetic(seed=args.seed, frames=args.synthetic_frames)
    p3_train, p2_train = load_train()
    p3_test, p2_test, valid = load_test()
    return p3_train, p2_train, p3_test, p2_test, valid


def _test_generator(data):
    _, _, p3_test, p2_test, valid = data
    keys = list(p2_test.keys())
    return UnchunkedGenerator(None, [p3_test[k] for k in keys], [p2_test[k] for k in keys],
                              valid_frames=[valid[k] for k in keys], keys=keys), keys


def run_training(args, data, d3dp_train, d3dp_valid, writer=None, resume_ckpt=None, mesh=None):
    """Training loop (reference main_3dhp.py:370-600): ChunkedGenerator ->
    Prefetcher (under either `--input-pipeline`) -> train step (root joint 14
    zeroed), validation P-Best at H=1, K=1 over the test sequences, lr
    decay, and the epoch and best checkpoints in `--ckpt-format`, waited for
    before returning. Returns the optimizer. `mesh`: as
    main_h36m.run_training."""
    model = d3dp_train.model
    dev = d3dp_train.device
    p3_train, p2_train = data[:2]

    lr = args.learning_rate
    optimizer = make_optimizer(model.parameters(), lr, weight_decay=0.1)
    step = make_train_step(d3dp_train, optimizer, root_joint=ROOT_JOINT, mesh=mesh)

    train_generator = ChunkedGenerator(
        args.batch_size // args.stride, None, list(p3_train.values()),
        list(p2_train.values()), args.number_of_frames, shuffle=True,
        augment=args.data_augmentation, kps_left=KPS_LEFT, kps_right=KPS_RIGHT,
        joints_left=KPS_LEFT, joints_right=KPS_RIGHT, pad_last=True)
    test_generator, _ = _test_generator(data)
    print(f"INFO: Training on {sum(p.shape[0] for p in p2_train.values())} frames")

    validator = Evaluator3DHP(d3dp_valid, receptive_field=args.number_of_frames,
                              batch_size=round_up_batch(args.eval_batch_size or 2, mesh),
                              quickdebug=args.debug, mesh=mesh)

    epoch, min_loss = 0, args.min_loss
    g_train = _generator(dev, args.seed, 1)
    g_valid = _generator(dev, args.seed, 2)
    log_path = os.path.join(args.checkpoint, "training_log.txt")
    save = checkpoint_saver(args, model, optimizer, train_generator)

    if args.resume:
        ckpt = resume_ckpt or load_any(os.path.join(args.checkpoint, args.resume))
        epoch, lr, min_loss = _resume(args, ckpt, model, optimizer, train_generator, lr,
                                      min_loss)

    while epoch < args.epochs:
        start_time = time()
        step_losses, step_weights = [], []
        to_device = None if mesh is None else shard_batch_fn(mesh)
        for _, b3, b2, w in Prefetcher(train_generator.next_epoch(), to_device=to_device,
                                       depth=2):
            step_losses.append(step(b2, b3, w, generator=g_train))
            step_weights.append(int(w.sum()) * args.number_of_frames)
            if args.debug:
                break
        losses_np = torch.stack(step_losses).double().cpu().numpy()
        weights_np = np.asarray(step_weights, dtype=np.float64)
        train_loss = float((losses_np * weights_np).sum()) / float(weights_np.sum())

        valid_pbest = None
        if not args.no_eval:
            results, _ = validator.evaluate(test_generator, g_valid)
            valid_pbest = float(results["P_Best"][0])

        elapsed = (time() - start_time) / 60
        lr = get_lr(optimizer)
        msg = "[%d] time %.2f lr %f 3d_train %f" % (epoch + 1, elapsed, lr, train_loss)
        if valid_pbest is not None:
            msg += " 3d_pos_valid %f" % valid_pbest
        print(msg)
        with _log_file(log_path) as f:
            f.write(msg + "\n")
        if writer is not None:
            writer.add_scalar("Loss/3d training loss", train_loss, epoch + 1)
            if valid_pbest is not None:
                writer.add_scalar("Loss/3d validation loss", valid_pbest, epoch + 1)
            writer.add_scalar("Parameters/learning rate", lr, epoch + 1)

        lr *= args.lr_decay
        set_lr(optimizer, lr)
        epoch += 1

        if epoch % args.checkpoint_frequency == 0:
            path = save(os.path.join(args.checkpoint, f"epoch_{epoch}"), epoch, lr, min_loss)
            print("Saving checkpoint to", path)
        if valid_pbest is not None and valid_pbest < min_loss:
            min_loss = valid_pbest
            print("save best checkpoint")
            save(os.path.join(args.checkpoint, "best_epoch"), epoch, lr, min_loss)
    wait_for_checkpoints()
    return optimizer


def run_evaluation(args, data, d3dp_eval, noise_provider=None, mesh=None):
    """Evaluate the test sequences: the masked P-Best / P-Agg per DDIM step
    into 3dhp_test_log_H{H}_K{K}.txt, the four inference_data_<mode>.mat
    exports into the checkpoint directory, then the PCK/AUC tables when
    3dhp_test/TS*/annot_data.mat exists. `noise_provider` (optional)
    replaces the sampler's draws (parity tests). `mesh` (optional): the
    micro-batches' windows split over its ranks; rank 0 writes the log, the
    exports and the tables. Returns {"P_Best", "P_Agg"}: (K,) in mm."""
    test_generator, test_keys = _test_generator(data)
    evaluator = Evaluator3DHP(d3dp_eval, receptive_field=args.number_of_frames,
                              batch_size=eval_batch_size(args, mesh, 2), quickdebug=args.debug,
                              mesh=mesh)
    rng = _generator(d3dp_eval.device, args.seed, 3)
    results, exports = evaluator.evaluate(test_generator, rng, export_dir=args.checkpoint,
                                          noise_provider=noise_provider)

    log_path = os.path.join(
        args.checkpoint, f"3dhp_test_log_H{args.num_proposals}_K{args.sampling_timesteps}.txt")
    with _log_file(log_path) as f:
        for ii in range(len(results["P_Best"])):
            for mode in ("P_Best", "P_Agg"):
                msg = "step %d : Protocol #1 Error (MPJPE) %s: %f mm" % (
                    ii, mode, results[mode][ii])
                print(msg)
                f.write(msg + "\n")

    # the MATLAB harness's tables, in Python, when the annotations are present
    annot_dir = "3dhp_test"
    # the exports are rank 0's (the other ranks print nothing)
    if process_index() == 0 and os.path.isdir(os.path.join(annot_dir, "TS1")):
        from d3dp_tpu_torch.metrics.pck_auc import evaluate_3dhp_mat

        for mode in MODES:
            summaries = evaluate_3dhp_mat(exports[mode], annot_dir, mode, args.checkpoint,
                                          n_seq=len(test_keys))
            last = max(summaries)
            print(f"{mode}: MPJPE {summaries[last]['mpjpe']:.2f} mm, "
                  f"PCK {summaries[last]['pck']:.2f}, "
                  f"AUC {summaries[last]['auc']:.2f} (t{last})")
    else:
        print("INFO: 3dhp_test/TS*/annot_data.mat not found; "
              "inference_data_<mode>.mat exported for external evaluation.")
    return results


def run_with_args(args, mesh=None):
    """The command line on this process's device: one device without a
    `mesh`, else this rank of it (`cli.arguments.launch`)."""
    device = resolve_device(device_of(args, mesh))
    if device.type == "cuda":
        disable_tf32()
    timestamp = "{0:%Y%m%dT%H-%M-%S}".format(datetime.now())
    writer = None
    if not args.nolog and process_index() == 0:
        logdir = args.log + "_" + timestamp
        os.makedirs(logdir, exist_ok=True)
        writer = TensorBoardWriter(logdir)
        writer.add_text("command", "python " + " ".join(sys.argv))
        sys.stdout = Logger(os.path.join(logdir, "logging.log"))
    print("Evaluate!" if args.evaluate else "Train!")
    print("Torch device:", device,
          torch.cuda.get_device_name(device) if device.type == "cuda" else "")
    mesh_note(mesh)

    if args.checkpoint == "":
        args.checkpoint = args.log + "_" + timestamp
    os.makedirs(args.checkpoint, exist_ok=True)

    print("Loading dataset...")
    data = _load_data(args)

    d3dp_train, d3dp_valid, d3dp_eval = _build_models(args, device)
    model = d3dp_train.model
    print("INFO: Trainable parameter count:",
          sum(p.numel() for p in model.parameters()) / 1e6, "Million")

    if args.resume in ("auto", "latest"):
        found = latest_checkpoint(args.checkpoint)
        args.resume = os.path.basename(found) if found else ""
        print("Auto-resume:", args.resume or "(no checkpoint found)")

    loaded_ckpt = None
    if args.resume or args.evaluate:
        chk_filename = os.path.join(args.checkpoint, args.resume or args.evaluate)
        print("Loading checkpoint", chk_filename)
        loaded_ckpt = load_any(chk_filename)
        model.load_state_dict(loaded_ckpt["model"])
    shard_model_params(model, mesh)  # the tensor-parallel split, as the JAX command line

    try:
        if args.evaluate:
            print("Evaluating...")
            return run_evaluation(args, data, d3dp_eval, mesh=mesh)
        return run_training(args, data, d3dp_train, d3dp_valid, writer, resume_ckpt=loaded_ckpt,
                            mesh=mesh)
    finally:
        if writer is not None:
            writer.close()


def main(argv=None):
    return launch(run_with_args, parse_args(argv))


if __name__ == "__main__":
    main()

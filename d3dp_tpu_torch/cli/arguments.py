"""Command-line flags of the H36M and MPI-INF-3DHP entry points.

Counterpart of d3dp_tpu/cli/arguments.py: the same flag names, defaults and
mutual exclusions (reference common/arguments.py:10-125 plus the JAX
package's extensions), so a command line written for `main.py` parses to
the same namespace here, and every value runs. `--input-pipeline grain`
runs the same background Prefetcher as `thread` (the JAX package's grain
pipeline yields the same batches, and grain imports JAX) and
`--ckpt-format orbax` a torch.distributed.checkpoint
directory (`train/checkpoint_io.py`), which the JAX package cannot read.
`--jax-cache` and `--num-virtual-devices` are accepted and inert: the
kernels' build directory (`ops/_build.py`, keyed by a hash of the sources)
is the port's counterpart of the compilation cache.

`launch` is the counterpart of the JAX package's `apply_platform_args`
for the process group: the command lines run one process a device (a
rank), started here with torch.multiprocessing or by torchrun.
"""

import argparse
import contextlib
import os

import torch
import torch.distributed as dist

from d3dp_tpu_torch.device import resolve_device
from d3dp_tpu_torch.parallel.mesh import auto_mesh, mesh_size
from d3dp_tpu_torch.parallel.multihost import initialize_multihost, spawn


def build_parser(in_the_wild=False):
    parser = argparse.ArgumentParser(description="Training script")

    # General arguments (reference arguments.py:14-36)
    parser.add_argument("-d", "--dataset", default="h36m", type=str, metavar="NAME",
                        help="target dataset: h36m | synthetic")
    parser.add_argument("-k", "--keypoints", default="cpn_ft_h36m_dbb", type=str,
                        metavar="NAME", help="2D detections to use")
    parser.add_argument("-str", "--subjects-train", default="S1,S5,S6,S7,S8",
                        type=str, metavar="LIST")
    parser.add_argument("-ste", "--subjects-test", default="S9,S11", type=str,
                        metavar="LIST")
    parser.add_argument("-sun", "--subjects-unlabeled", default="", type=str,
                        metavar="LIST")
    parser.add_argument("-a", "--actions", default="*", type=str, metavar="LIST")
    parser.add_argument("-c", "--checkpoint", default="", type=str, metavar="PATH",
                        help="checkpoint directory")
    parser.add_argument("-l", "--log", default="log/default", type=str,
                        metavar="PATH")
    parser.add_argument("-cf", "--checkpoint-frequency", default=20, type=int,
                        metavar="N")
    parser.add_argument("-r", "--resume", default="", type=str, metavar="FILENAME")
    parser.add_argument("--nolog", action="store_true")
    parser.add_argument("--evaluate", default="", type=str, metavar="FILENAME")
    parser.add_argument("--render", action="store_true")
    parser.add_argument("--by-subject", action="store_true")
    parser.add_argument("--export-training-curves", action="store_true")

    # Model arguments (reference arguments.py:39-59)
    stride_default = 1 if in_the_wild else 243
    epochs_default = 120 if in_the_wild else 400
    lr_default = 4e-5 if in_the_wild else 6e-5
    lrd_default = 0.99 if in_the_wild else 0.993
    parser.add_argument("-s", "--stride", default=stride_default, type=int, metavar="N")
    parser.add_argument("-e", "--epochs", default=epochs_default, type=int, metavar="N")
    parser.add_argument("-b", "--batch-size", default=1024, type=int, metavar="N",
                        help="batch size in terms of predicted frames")
    parser.add_argument("-drop", "--dropout", default=0.0, type=float, metavar="P")
    parser.add_argument("-lr", "--learning-rate", default=lr_default, type=float)
    parser.add_argument("-lrd", "--lr-decay", default=lrd_default, type=float)
    parser.add_argument("--coverlr", action="store_true")
    parser.add_argument("-mloss", "--min_loss", default=100000, type=float)
    parser.add_argument("-no-da", "--no-data-augmentation",
                        dest="data_augmentation", action="store_false")
    parser.add_argument("-cs", default=512, type=int, help="model channel width")
    parser.add_argument("-dep", default=8, type=int, help="model depth")
    parser.add_argument("-alpha", default=0.01, type=float)
    parser.add_argument("-beta", default=2, type=float)
    parser.add_argument("--postrf", action="store_true",
                        help="accepted for compatibility (dead in reference)")
    parser.add_argument("--ftpostrf", action="store_true",
                        help="accepted for compatibility (dead in reference)")
    parser.add_argument("-f", "--number-of-frames", default=243, type=int,
                        metavar="N")

    # Experimental (reference arguments.py:64-78)
    parser.add_argument("-gpu", default="0", type=str,
                        help="accepted for compatibility; the port runs on CUDA device 0 "
                             "unless --platform cpu")
    parser.add_argument("--subset", default=1, type=float, metavar="FRACTION")
    parser.add_argument("--downsample", default=1, type=int, metavar="FACTOR")
    parser.add_argument("--warmup", default=1, type=int, metavar="N")
    parser.add_argument("--no-eval", action="store_true")
    parser.add_argument("--dense", action="store_true")
    parser.add_argument("--disable-optimizations", action="store_true")
    parser.add_argument("--linear-projection", action="store_true")
    parser.add_argument("--no-bone-length", action="store_false",
                        dest="bone_length_term")
    parser.add_argument("--no-proj", action="store_true")
    parser.add_argument("--ft", action="store_true")
    parser.add_argument("--ftpath", default="checkpoint/exp13_ft2d", type=str)
    parser.add_argument("--ftchk", default="epoch_330.pth", type=str)
    parser.add_argument("--no_eval", action="store_true", default=False)

    # Visualization (reference arguments.py:81-93)
    parser.add_argument("--viz-subject", type=str, metavar="STR")
    parser.add_argument("--viz-action", type=str, metavar="STR")
    parser.add_argument("--viz-camera", type=int, default=0, metavar="N")
    parser.add_argument("--viz-video", type=str, metavar="PATH")
    parser.add_argument("--viz-skip", type=int, default=0, metavar="N")
    parser.add_argument("--viz-output", type=str, metavar="PATH")
    parser.add_argument("--viz-export", type=str, metavar="PATH")
    parser.add_argument("--viz-bitrate", type=int, default=3000, metavar="N")
    parser.add_argument("--viz-no-ground-truth", action="store_true")
    parser.add_argument("--viz-limit", type=int, default=-1, metavar="N")
    parser.add_argument("--viz-downsample", type=int, default=1, metavar="N")
    parser.add_argument("--viz-size", type=int, default=5, metavar="N")
    parser.add_argument("--compare", action="store_true", default=False)

    # linear-model flags (reference arguments.py:97-99, dead paths)
    parser.add_argument("-lcs", "--linear_channel_size", type=int, default=1024)
    parser.add_argument("-depth", type=int, default=4)
    parser.add_argument("-ldg", "--lr_decay_gap", type=float, default=10000)

    # Diffusion (reference arguments.py:101-107)
    parser.add_argument("-scale", default=1.0, type=float, help="SNR scale")
    parser.add_argument("-timestep", type=int, default=1000, metavar="N")
    parser.add_argument("-sampling_timesteps", type=int, default=5, metavar="N")
    parser.add_argument("-num_proposals", type=int, default=300, metavar="N")
    parser.add_argument("--debug", action="store_true", default=False)
    parser.add_argument("--p2", action="store_true", default=False)
    parser.add_argument("--p2-device", action="store_true", default=False,
                        help="Protocol-2 on the device beside Protocol-1 (implies --p2)")

    # ---------------------- extensions of the JAX package ----------------------
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"],
                        help="model compute dtype (bfloat16 = fast path)")
    parser.add_argument("--attention", default="auto",
                        choices=["auto", "xla", "pallas"],
                        help="auto | pallas: the hand-written kernels (on the "
                             "card; with --platform cpu every op runs its plain "
                             "torch version). xla: the plain path, which exists "
                             "only on the CPU (--platform cpu); on the card it "
                             "raises")
    parser.add_argument("--fuse-level", type=int, default=4,
                        choices=[0, 1, 2, 3, 4, 5],
                        help="eval-path kernel ladder: 0 = composed block with "
                             "the attention-core kernel, 1 = + MLP-block kernel, "
                             "2 = + attention-block kernel, 3 = transpose-free "
                             "flow, 4 = + attention-stage kernel (two kernels per "
                             "block), 5 = the whole trunk in one depth-resident "
                             "kernel. Training always runs the composed block")
    parser.add_argument("--ddim-reuse", type=int, default=0, metavar="N",
                        help="DDIM feature reuse (evaluation): run the full "
                             "model every N-th step and the last, and in between "
                             "only the first --ddim-reuse-tap block pairs plus "
                             "the cached deep delta (0/1 = off)")
    parser.add_argument("--ddim-reuse-tap", type=int, default=2, metavar="D",
                        help="block pairs computed fresh on a reuse step "
                             "(clamped to 1..-dep)")
    parser.add_argument("--ddim-reuse-adaptive", type=float, default=0.0,
                        metavar="TAU",
                        help="also refresh when the noisy pose drifted more than "
                             "TAU (relative L2) since the last refresh (0 = off)")
    parser.add_argument("--jax-cache", default=os.environ.get(
                            "JAX_COMPILATION_CACHE_DIR",
                            os.path.expanduser("~/.cache/d3dp_tpu/jax")),
                        metavar="DIR",
                        help="accepted for compatibility and inert: the port's "
                             "kernels are built once into d3dp_tpu_torch/_build/, "
                             "keyed by a hash of their sources")
    parser.add_argument("--platform", default="",
                        help="cpu = run on the CPU (every op's plain torch "
                             "version); empty, cuda or gpu = the card")
    parser.add_argument("--num-virtual-devices", type=int, default=0,
                        help="accepted for compatibility and inert")
    parser.add_argument("--ckpt-format", default="pickle",
                        choices=["pickle", "orbax"],
                        help="pickle = one atomic torch.save file with the "
                             "original's payload; orbax = the same payload as a "
                             "torch.distributed.checkpoint directory (epoch_N.orbax), "
                             "written asynchronously (not the JAX package's orbax)")
    parser.add_argument("--input-pipeline", default="thread",
                        choices=["thread", "grain"],
                        help="thread = background prefetcher; grain = the same "
                             "prefetcher (the JAX package's grain pipeline yields "
                             "the same batches; grain imports JAX, so it is not used)")
    parser.add_argument("--multihost", action="store_true",
                        help="join the process group from torchrun's environment "
                             "(use the coordinator flags for manual bring-up)")
    parser.add_argument("--coordinator-address", default="", metavar="HOST:PORT",
                        help="multi-host coordinator (implies --multihost)")
    parser.add_argument("--num-hosts", type=int, default=0, metavar="N",
                        help="with --coordinator-address: the number of processes, "
                             "one a device")
    parser.add_argument("--host-id", type=int, default=-1, metavar="I",
                        help="with --coordinator-address: this process's rank; it "
                             "drives card I modulo the host's card count")
    parser.add_argument("--dp", type=int, default=0,
                        help="data-parallel mesh size (0 = all devices: every "
                             "card, or one CPU rank with --platform cpu; N > 1 "
                             "starts one process a rank)")
    parser.add_argument("--tp", type=int, default=1,
                        help="tensor-parallel mesh size (attention heads and MLP "
                             "hidden units split over N ranks; with --dp, dp x tp "
                             "ranks)")
    parser.add_argument("--seed", type=int, default=1,
                        help="global seed (reference fixes 1, main.py:67-71)")
    parser.add_argument("--eval-batch-size", type=int, default=0, metavar="N",
                        help="eval windows per sampling call (0 = use -b, the "
                             "reference behaviour; set small when -b is a "
                             "large training batch)")
    parser.add_argument("--profile", default="", metavar="DIR",
                        help="write a torch.profiler Chrome trace of the first "
                             "training epoch (or the first evaluated action) "
                             "to DIR/trace.json, and the program's spans (each "
                             "with its device ms) and counters of the same "
                             "block to DIR/program.json")
    parser.add_argument("--synthetic-frames", type=int, default=1200,
                        help="--dataset synthetic: total frames per split")

    parser.set_defaults(bone_length_term=True)
    parser.set_defaults(data_augmentation=True)
    parser.set_defaults(test_time_augmentation=True)
    return parser


def parse_args(argv=None, in_the_wild=False):
    parser = build_parser(in_the_wild=in_the_wild)
    args = parser.parse_args(argv)
    # reference's mutual exclusions (arguments.py:117-123)
    if args.resume and args.evaluate:
        parser.error("--resume and --evaluate cannot be set at the same time")
    if args.export_training_curves and args.no_eval:
        parser.error("--export-training-curves and --no-eval cannot be set "
                     "at the same time")
    if (args.num_hosts or args.host_id >= 0) and not args.coordinator_address:
        parser.error("--num-hosts/--host-id require --coordinator-address "
                     "(without it, the process group is read from torchrun's "
                     "environment and would silently ignore them)")
    if args.platform not in ("", "cpu", "cuda", "gpu"):
        parser.error(f"--platform {args.platform}: the port runs on cpu or cuda")
    if args.attention == "xla" and args.platform != "cpu":
        parser.error("--attention xla is the plain path, which runs only on the CPU: "
                     "pass --platform cpu, or use --attention auto|pallas on the card")
    if args.p2_device:
        args.p2 = True  # --p2-device implies Protocol-2 reporting
    return args


def device_of(args, mesh=None):
    """The torch device the command line asks for: this rank's under a
    mesh, the CPU with --platform cpu, else the card."""
    if mesh is not None:
        return mesh.device
    return "cpu" if args.platform == "cpu" else None


def _visible_devices(args):
    """One entry per rank under a running process group (rank r on card r
    modulo the card count); without one, every card, or on the CPU --dp x
    --tp CPU ranks (one by default)."""
    cpu = args.platform == "cpu"
    if dist.is_initialized():
        world = dist.get_world_size()
        return ["cpu"] * world if cpu else [
            f"cuda:{r % torch.cuda.device_count()}" for r in range(world)]
    if cpu:
        return ["cpu"] * (max(args.dp, 1) * max(args.tp, 1))
    resolve_device(None)  # no card: raise, as every entry point does
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def _run_rank(entry, args, devices):
    """entry(args, mesh) on this rank; the ranks other than 0 print nothing."""
    mesh = auto_mesh(args.dp, args.tp, devices)
    if mesh is None or mesh.rank == 0:
        return entry(args, mesh)
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        return entry(args, mesh)


def launch(entry, args):
    """Run `entry(args, mesh)` on every rank the command line asks for.

    With --multihost or --coordinator-address, or under torchrun (its
    RANK / WORLD_SIZE environment), this process joins the process group
    (`initialize_multihost`) and runs its rank. Otherwise --dp/--tp resolve
    over the visible devices as JAX's `auto_mesh` does: one device runs
    entry(args, None) here, today's path with no process group; more start
    one worker process a rank (start method spawn) over a process group on
    localhost, nccl on the cards and gloo on the CPU. Returns entry's
    result: rank 0's where the ranks ran in worker processes (a copy).
    Logs, checkpoints and exports come from rank 0."""
    backend = "gloo" if args.platform == "cpu" else "nccl"
    joining = args.multihost or args.coordinator_address or (
        "RANK" in os.environ and "WORLD_SIZE" in os.environ)
    if joining and not dist.is_initialized():
        rank, world = initialize_multihost(
            coordinator_address=args.coordinator_address or None,
            num_processes=args.num_hosts or None,
            process_id=args.host_id if args.host_id >= 0 else None, backend=backend)
        print(f"multihost: process {rank}/{world}")
    if dist.is_initialized():
        return _run_rank(entry, args, _visible_devices(args))
    devices = _visible_devices(args)
    world = mesh_size(args.dp, args.tp, len(devices))
    if world == 1:
        return entry(args, None)
    return spawn(_run_rank, world, entry, args, devices[:world], backend=backend)

"""Checkpoints: the original's `torch.save` payload, written atomically.

Counterpart of d3dp_tpu/train/checkpoint_io.py's pickle format. The payload
is the original's (reference main.py:539-572; SURVEY.md section 5):
{epoch, lr, random_state, optimizer, model_pos, min_loss}, with the port's
MixSTE2 state_dict (the original's key names, without the DataParallel and
diffusion-wrapper prefixes) under `model_pos`, the AdamW state_dict under
`optimizer`, and the training generator's np.random.RandomState under
`random_state`. `load_any` also reads an original `.bin`.

Under a process group every rank calls `save_checkpoint` and only rank 0
writes (the ranks' weights are equal), the others waiting at a barrier
until the file is in place; every rank loads on resume. The keys are the
model's own, with no `module.` prefix. Under tensor parallelism
(`parallel.mesh.shard_params`) the split parameters and their AdamW
moments (`exp_avg`, `exp_avg_sq`) are gathered over the tp group into the
whole tensors first, and `shard_checkpoint` slices a loaded checkpoint for
a rank, so a checkpoint moves between runs on any number of ranks and any
(dp, tp) layout.

A checkpoint holds pickled Python objects (the RandomState), as the
original's does, so it is loaded with `weights_only=False`: load only
checkpoints this program or the original wrote.

`--ckpt-format orbax` (`save_checkpoint_orbax`, `load_checkpoint_orbax`,
`save_checkpoint_any`): the JAX package's second format, an orbax
checkpoint directory, is here a directory in torch.distributed.checkpoint
(DCP) format holding the same payload, gathered whole as the pickle's is
(so free of the (dp, tp) layout): its tensors as DCP entries, the rest
(the RandomState, the epoch, lr, min_loss and the optimizer's
param_groups) pickled into one uint8 entry. The JAX package cannot read
it, nor the port an orbax directory. Rank 0 writes it alone, without
collectives: the payload is whole on every rank, and the write runs in the
background, where a collective would race the training's own on the same
group. Saves are asynchronous (`wait=False`): the payload is copied to the
host at once, then `dcp.async_save(no_dist=True)` writes it from its own
thread, without a process group (torch 2.11 and later), into `<dir>.tmp`,
renamed over the directory when complete (the old one moved aside to
`<dir>.old` until then, `_replace_dir`). One save is in flight at a time
(the next waits for it, as orbax's does);
`wait_for_checkpoints` waits for it, and every process waits at exit (the
command lines call it at the end of training: spawned ranks skip `atexit`).
"""

import atexit
import glob
import os
import pickle
import re
import shutil
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from d3dp_tpu_torch.parallel.mesh import (
    gather_params,
    gather_tensor,
    mixste_param_spec,
    process_index,
    shard_tensor,
    split_state_dict,
)
from d3dp_tpu_torch.train.convert import load_reference_checkpoint

_PREFIXES = ("module.", "pose_estimator.")


def _moments(opt_state, model, fn):
    """The AdamW state_dict with fn(name, spec, tensor) applied to each
    parameter's `exp_avg` and `exp_avg_sq` (its keys are the parameters'
    positions in model.parameters(), the optimizer's one group)."""
    names = [n for n, _ in model.named_parameters()]
    spec = mixste_param_spec(dict(model.named_parameters()))
    state = {}
    for i, st in opt_state["state"].items():
        st = dict(st)
        for k in ("exp_avg", "exp_avg_sq"):
            if k in st:
                st[k] = fn(names[i], spec[names[i]], st[k])
        state[i] = st
    return dict(opt_state, state=state)


def shard_checkpoint(ckpt, model):
    """A `load_any` checkpoint for a model that `shard_params` split: the
    weights and the AdamW moments sliced to its rank; unchanged for an
    unsplit model."""
    tp = model.tp
    if tp is None:
        return ckpt
    out = dict(ckpt, model=split_state_dict(ckpt["model"], tp.size, tp.index))
    if ckpt.get("optimizer") is not None:
        out["optimizer"] = _moments(ckpt["optimizer"], model, lambda n, spec, t: shard_tensor(
            n, t, spec, tp.size, tp.index).contiguous())
    return out


def _payload(epoch, lr, model, optimizer, generator_random_state, min_loss):
    """The original's payload with a split model's weights and moments
    gathered over its tp group (a collective: every rank calls it); the
    same dict on every rank."""
    model_pos = gather_params(model)
    opt_state = None if optimizer is None else optimizer.state_dict()
    if opt_state is not None and model.tp is not None:
        opt_state = _moments(opt_state, model, lambda n, spec, t: gather_tensor(
            n, t, spec, model.tp))
    return {"epoch": epoch, "lr": lr, "random_state": generator_random_state,
            "optimizer": opt_state, "model_pos": model_pos, "min_loss": min_loss}


def save_checkpoint(path, *, epoch, lr, model, optimizer=None, generator_random_state=None,
                    min_loss=None):
    """Write the payload to `path + ".tmp"`, then rename it over `path`, so
    an interrupted save never leaves a truncated checkpoint. Rank 0 writes;
    under a process group every rank waits at a barrier until it has. A
    split model's weights and moments are gathered over its tp group first
    (every rank takes part)."""
    payload = _payload(epoch, lr, model, optimizer, generator_random_state, min_loss)
    if process_index() == 0:
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    if dist.is_initialized():
        dist.barrier()


# ------------------------------------------------- --ckpt-format orbax (DCP)
class _TensorRef:
    """A DCP entry's place in the pickled rest of the payload."""

    def __init__(self, key):
        self.key = key


def _flatten(payload):
    """({key: a host copy of each tensor of payload}, the payload with each
    tensor replaced by a _TensorRef)."""
    tensors = {}

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            key = f"t{len(tensors)}"
            tensors[key] = obj.detach().to("cpu", copy=True).contiguous()
            return _TensorRef(key)
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(v) for v in obj)
        return obj
    return tensors, walk(payload)


def _unflatten(skeleton, tensors):
    def walk(obj):
        if isinstance(obj, _TensorRef):
            return tensors[obj.key]
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(walk(v) for v in obj)
        return obj
    return walk(skeleton)


# DCP warns when it writes or reads in a single process (also from its own
# writer thread): here it does so by design
warnings.filterwarnings("ignore", message="torch.distributed is disabled, unavailable or "
                        "uninitialized, assuming the intent is to")


_writer = None  # a one-thread pool: the rename after each write
_pending = None  # the save in flight: a Future of the pool


def _replace_dir(tmp, directory):
    """Rename the complete `tmp` over `directory`. A directory cannot be
    renamed over another, so the old one is moved aside to `<dir>.old`
    first and removed last: a crash at any point leaves a whole checkpoint
    under `directory` or, between the two renames, under `<dir>.old`, which
    `load_any` and `latest_checkpoint` read in its place (`_orbax_path`)."""
    old = directory + ".old"
    if os.path.exists(directory):
        shutil.rmtree(old, ignore_errors=True)
        os.replace(directory, old)
    os.replace(tmp, directory)
    shutil.rmtree(old, ignore_errors=True)


def _orbax_path(path):
    """`path`, or the previous checkpoint that an interrupted
    `_replace_dir` left at `<path>.old` when `path` is missing."""
    if not os.path.exists(path) and os.path.isdir(path + ".old"):
        return path + ".old"
    return path


def _finish(write, tmp, directory):
    """Complete one save in the pool's thread: wait for the write (the
    Future of `dcp.async_save`), then rename."""
    write.result()
    _replace_dir(tmp, directory)


def wait_for_checkpoints():
    """Block until the pending asynchronous save, if any, is complete on
    disk (its errors raise here)."""
    global _pending
    if _pending is not None:
        pending, _pending = _pending, None
        pending.result()


def save_checkpoint_orbax(directory, *, epoch, lr, model, optimizer=None,
                          generator_random_state=None, min_loss=None, wait=True):
    """The payload of `save_checkpoint` as a DCP directory (module
    docstring). wait=False returns once the payload is on the host, the
    write running behind the next steps; wait=True also waits for it, and
    under a process group every rank then waits at a barrier, as
    `save_checkpoint` does. A split model is gathered first (every rank
    takes part)."""
    global _writer, _pending
    payload = _payload(epoch, lr, model, optimizer, generator_random_state, min_loss)
    if process_index() == 0:
        wait_for_checkpoints()  # one save in flight
        tensors, skeleton = _flatten(payload)
        tensors["payload"] = torch.from_numpy(
            np.frombuffer(pickle.dumps(skeleton, protocol=pickle.HIGHEST_PROTOCOL),
                          np.uint8).copy())
        directory = os.path.abspath(directory)
        tmp = directory + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        if _writer is None:
            _writer = ThreadPoolExecutor(1, thread_name_prefix="checkpoint")
            atexit.register(wait_for_checkpoints)
        write = dcp.async_save(tensors, checkpoint_id=tmp, no_dist=True)
        _pending = _writer.submit(_finish, write, tmp, directory)
        if wait:
            wait_for_checkpoints()
    if wait and dist.is_initialized():
        dist.barrier()


def load_checkpoint_orbax(directory):
    """The payload of a `save_checkpoint_orbax` directory (after any
    pending save of this process completes), on the CPU."""
    wait_for_checkpoints()
    reader = dcp.FileSystemReader(directory)
    meta = reader.read_metadata().state_dict_metadata
    flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype) for k, m in meta.items()}
    dcp.load(flat, storage_reader=reader, no_dist=True)
    skeleton = pickle.loads(flat.pop("payload").numpy().tobytes())
    return _unflatten(skeleton, flat)


def save_checkpoint_any(path, fmt="pickle", **kw):
    """Save in `--ckpt-format` fmt: "pickle" (`save_checkpoint`, one atomic
    file; `wait` is dropped) or "orbax" (`save_checkpoint_orbax`, a DCP
    directory; wait=False for the asynchronous periodic saves)."""
    if fmt == "orbax":
        save_checkpoint_orbax(path, **kw)
    else:
        kw.pop("wait", None)
        save_checkpoint(path, **kw)


def load_any(path):
    """A checkpoint written by `save_checkpoint` or `save_checkpoint_orbax`
    (a directory), or an original `.bin`.

    Returns {"model": MixSTE2 state_dict (CPU tensors), "epoch", "lr",
    "optimizer", "random_state", "min_loss"}; for an original `.bin` the
    last three are None (its optimizer state belongs to the original's
    parameter order), as the JAX package's `load_any` returns them.
    """
    wait_for_checkpoints()  # this process's pending save may be the one asked for
    path = _orbax_path(path)
    if os.path.isdir(path):
        ckpt = load_checkpoint_orbax(path)
    else:
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not isinstance(ckpt, dict) or "model_pos" not in ckpt:
        raise ValueError(f"{path}: not a checkpoint (no 'model_pos' entry)")
    if not any(k.startswith(_PREFIXES) for k in ckpt["model_pos"]):
        return {"model": ckpt["model_pos"], "epoch": ckpt.get("epoch"), "lr": ckpt.get("lr"),
                "optimizer": ckpt.get("optimizer"), "random_state": ckpt.get("random_state"),
                "min_loss": ckpt.get("min_loss")}
    sd, meta = load_reference_checkpoint(path)
    return {"model": sd, "epoch": meta.get("epoch", 0), "lr": meta.get("lr"),
            "optimizer": None, "random_state": None, "min_loss": None}


def latest_checkpoint(directory):
    """Newest epoch_N.ckpt or epoch_N.orbax in a directory, else
    best_epoch.ckpt, else best_epoch.orbax, else None (`--resume auto`).
    An orbax checkpoint left at `<name>.old` by an interrupted replacement
    counts under its name (`load_any` reads it there)."""
    candidates = (glob.glob(os.path.join(directory, "epoch_*.ckpt"))
                  + glob.glob(os.path.join(directory, "epoch_*.orbax"))
                  + [p[:-len(".old")] for p in glob.glob(os.path.join(directory,
                                                                      "epoch_*.orbax.old"))])
    if candidates:
        return max(candidates, key=lambda p: int(re.findall(r"epoch_(\d+)", p)[-1]))
    for name in ("best_epoch.ckpt", "best_epoch.orbax"):
        best = os.path.join(directory, name)
        if os.path.exists(_orbax_path(best)):
            return best
    return None

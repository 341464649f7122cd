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
"""

import glob
import os
import re

import torch
import torch.distributed as dist

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


def save_checkpoint(path, *, epoch, lr, model, optimizer=None, generator_random_state=None,
                    min_loss=None):
    """Write the payload to `path + ".tmp"`, then rename it over `path`, so
    an interrupted save never leaves a truncated checkpoint. Rank 0 writes;
    under a process group every rank waits at a barrier until it has. A
    split model's weights and moments are gathered over its tp group first
    (every rank takes part)."""
    model_pos = gather_params(model)
    opt_state = None if optimizer is None else optimizer.state_dict()
    if opt_state is not None and model.tp is not None:
        opt_state = _moments(opt_state, model, lambda n, spec, t: gather_tensor(
            n, t, spec, model.tp))
    if process_index() == 0:
        payload = {
            "epoch": epoch,
            "lr": lr,
            "random_state": generator_random_state,
            "optimizer": opt_state,
            "model_pos": model_pos,
            "min_loss": min_loss,
        }
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    if dist.is_initialized():
        dist.barrier()


def load_any(path):
    """A checkpoint written by `save_checkpoint`, or an original `.bin`.

    Returns {"model": MixSTE2 state_dict (CPU tensors), "epoch", "lr",
    "optimizer", "random_state", "min_loss"}; for an original `.bin` the
    last three are None (its optimizer state belongs to the original's
    parameter order), as the JAX package's `load_any` returns them.
    """
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
    """Newest epoch_N.ckpt in a directory, else best_epoch.ckpt, else None
    (`--resume auto`)."""
    candidates = glob.glob(os.path.join(directory, "epoch_*.ckpt"))
    if candidates:
        return max(candidates, key=lambda p: int(re.findall(r"epoch_(\d+)", p)[-1]))
    best = os.path.join(directory, "best_epoch.ckpt")
    return best if os.path.exists(best) else None

"""Optimizer and train step: AdamW with per-epoch learning-rate decay.

Counterpart of d3dp_tpu/train/state.py (reference recipe main.py:309,
:529-531): AdamW(lr=6e-5, weight_decay=0.1 on every parameter, one group, as
the reference and optax's `adamw` do), lr *= lr_decay each epoch through
`set_lr`. The state lives in the model's parameters and the optimizer, so
the step updates them in place and returns only the loss.
"""

import itertools

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from d3dp_tpu_torch.parallel.mesh import batch_rows
from d3dp_tpu_torch.utils import profiling


def make_optimizer(params, learning_rate, weight_decay=0.1):
    """AdamW over `params` in one group; betas and eps at the torch defaults,
    which are optax's."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def get_lr(optimizer):
    return float(optimizer.param_groups[0]["lr"])


def set_lr(optimizer, lr):
    for group in optimizer.param_groups:
        group["lr"] = lr
    return optimizer


def weighted_mpjpe(pred, target, weights, total=None):
    """Masked MPJPE: mean over valid batch rows only. weights: (B,) 0/1; the
    denominator is sum(w) * F * J, or total * F * J where `total` is given
    (a data-parallel rank's share of the global batch's mean: the ranks'
    shares sum to it)."""
    err = torch.sqrt(torch.sum(torch.square(pred - target), dim=-1))  # (B, F, J)
    w = weights[:, None, None].to(err.dtype)
    total = torch.sum(weights) if total is None else total
    return torch.sum(err * w) / (total * err.shape[1] * err.shape[2])


def make_train_step(d3dp, optimizer, root_joint=0, mesh=None):
    """Build the train step.

    step(x2d, x3d, weights, generator=None, t_noise_override=None) -> loss,
    a 0-d device tensor (no host sync).
    x3d arrives with the trajectory in the root joint; it is root-zeroed here
    before both conditioning and loss (main.py:381-382 -- joint 0 for H36M).
    Inputs may be numpy arrays or tensors; they move to the model's device.

    Under a data-parallel `mesh` (parallel/mesh.py), x2d and x3d are this
    rank's rows of the global batch (`shard_batch_fn`) and `weights` the
    global batch's (B,) weights; t, the noise and the DropPath masks are
    drawn for the global batch from `generator` (the same seed on every
    rank) and each rank keeps its rows, and `t_noise_override` is global
    too. Each rank's loss is its share of the global weighted mean (the
    global sum of weights in the denominator), so the gradients summed over
    the ranks are the global mean's: DistributedDataParallel averages them
    over the ranks while the backward runs, so its loss is that share
    times the world size. The step returns the global mean, summed over
    the ranks. The ranks' parameters start equal (the wrapper broadcasts
    rank 0's) and stay equal: each applies the same gradients. The wrapper
    runs `d3dp.model` itself, so the sampler and its weight cache read the
    trained parameters as they do on one device.

    Under a mesh with tp > 1 (`d3dp.model` split by `parallel.mesh.
    shard_params` first) the ranks of a tp group take the same rows and
    draws; data parallelism runs over the dp group alone (the wrapper over
    `mesh.dp_group`, none at dp 1), the loss scaled by dp and summed over
    that group. The gradients of the replicated parameters come out equal
    across a tp group by construction (`parallel.tp`), so its ranks apply
    the same updates to them.
    """
    if mesh is not None:
        return _make_dp_step(d3dp, optimizer, root_joint, mesh)
    dev = d3dp.device
    steps = itertools.count()  # the unit of each step's spans

    def step(x2d, x3d, weights, generator=None, t_noise_override=None):
        with profiling.span("train.step", unit=next(steps), device=dev):
            with profiling.span("train.feed", sync=True):
                profiling.count_uploads(dev, x2d, x3d, weights)
                x2d = torch.as_tensor(x2d, dtype=torch.float32, device=dev)
                x3d = torch.as_tensor(x3d, dtype=torch.float32, device=dev).clone()
                weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
                x3d[:, :, root_joint] = 0.0
            with profiling.span("train.forward", device=dev):
                pred = d3dp.train_forward(x2d, x3d, train=True, generator=generator,
                                          t_noise_override=t_noise_override)
                loss = weighted_mpjpe(pred, x3d, weights)
            with profiling.span("train.backward", device=dev):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
            with profiling.span("train.optimizer", device=dev):
                optimizer.step()
            return loss.detach()

    return step


def _make_dp_step(d3dp, optimizer, root_joint, mesh):
    dev = d3dp.device
    ddp = DistributedDataParallel(d3dp.model, process_group=mesh.dp_group) if mesh.dp > 1 else None
    dropping = d3dp.cfg.model.drop_path_rate > 0
    steps = itertools.count()

    def step(x2d, x3d, weights, generator=None, t_noise_override=None):
        with profiling.span("train.step", unit=next(steps), device=dev):
            with profiling.span("train.feed", sync=True):
                profiling.count_uploads(dev, x2d, x3d)
                # the weights' sum read on the host, or their rows' upload
                profiling.count("host_syncs")
                w_global = torch.as_tensor(weights, dtype=torch.float32)
                B = w_global.shape[0]
                rows = batch_rows(B, mesh)
                x2d = torch.as_tensor(x2d, dtype=torch.float32, device=dev)
                x3d = torch.as_tensor(x3d, dtype=torch.float32, device=dev).clone()
                x3d[:, :, root_joint] = 0.0
                # the global weight sum as a device tensor: the division is
                # then the one-device step's, bit for bit at world size 1
                total = torch.full((), float(w_global.sum()), device=dev)
                w_rows = w_global[rows].to(dev)
            with profiling.span("train.forward", device=dev):
                if t_noise_override is None:
                    if generator is None:
                        raise ValueError("the train step needs a torch.Generator or "
                                         "t_noise_override")
                    t, noise = d3dp.train_noise(B, generator)
                else:
                    profiling.count_uploads(dev, *t_noise_override)
                    t, noise = (torch.as_tensor(a, device=dev) for a in t_noise_override)
                masks = None
                if dropping:
                    if generator is None:
                        raise ValueError("DropPath needs a torch.Generator")
                    masks = d3dp.model.draw_droppath_masks(B, generator, rows)
                pred = d3dp.train_forward(x2d, x3d, train=True,
                                          t_noise_override=(t[rows], noise[rows]),
                                          droppath_masks=masks, module=ddp)
                loss = weighted_mpjpe(pred, x3d, w_rows, total=total)
            with profiling.span("train.backward", device=dev):
                optimizer.zero_grad(set_to_none=True)
                (loss * mesh.dp).backward()
            with profiling.span("train.optimizer", device=dev):
                optimizer.step()
                loss = loss.detach().clone()
                dist.all_reduce(loss, group=mesh.dp_group)
            return loss

    return step

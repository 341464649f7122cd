"""Optimizer and train step: AdamW with per-epoch learning-rate decay.

Counterpart of d3dp_tpu/train/state.py (reference recipe main.py:309,
:529-531): AdamW(lr=6e-5, weight_decay=0.1 on every parameter, one group, as
the reference and optax's `adamw` do), lr *= lr_decay each epoch through
`set_lr`. The state lives in the model's parameters and the optimizer, so
the step updates them in place and returns only the loss.
"""

import torch


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


def weighted_mpjpe(pred, target, weights):
    """Masked MPJPE: mean over valid batch rows only. weights: (B,) 0/1; the
    denominator is sum(w) * F * J."""
    err = torch.sqrt(torch.sum(torch.square(pred - target), dim=-1))  # (B, F, J)
    w = weights[:, None, None].to(err.dtype)
    return torch.sum(err * w) / (torch.sum(weights) * err.shape[1] * err.shape[2])


def make_train_step(d3dp, optimizer, root_joint=0):
    """Build the train step.

    step(x2d, x3d, weights, generator=None, t_noise_override=None) -> loss,
    a 0-d device tensor (no host sync).
    x3d arrives with the trajectory in the root joint; it is root-zeroed here
    before both conditioning and loss (main.py:381-382 -- joint 0 for H36M).
    Inputs may be numpy arrays or tensors; they move to the model's device.
    """
    dev = d3dp.device

    def step(x2d, x3d, weights, generator=None, t_noise_override=None):
        x2d = torch.as_tensor(x2d, dtype=torch.float32, device=dev)
        x3d = torch.as_tensor(x3d, dtype=torch.float32, device=dev).clone()
        weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
        x3d[:, :, root_joint] = 0.0
        pred = d3dp.train_forward(x2d, x3d, train=True, generator=generator,
                                  t_noise_override=t_noise_override)
        loss = weighted_mpjpe(pred, x3d, weights)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step

"""D3DP's training step in plain PyTorch: the draws of a step, the noised
forward with DropPath, the masked MPJPE loss and AdamW (main.py's train
loop: AdamW lr 6e-5, weight decay 0.1 on every parameter, betas 0.9 and
0.999, eps 1e-8).

The step's random draws come from a torch.Generator in this order: t (B,)
and the noise (B, F, J, 3), then for each depth i and each of the spatial
and the temporal block whose DropPath rate is above 0, two uniform vectors
of one value a row (B*F spatial rows, B*J temporal), each a mask of
1/keep where u < keep and 0 elsewhere. `draws` replays them from a
generator state.
"""

import torch

from port_bench.reference import diffusion
from port_bench.reference.model import droppath_rates


def draws(state, device, B, model_cfg, timesteps):
    """(t, noise, masks) of one step from a generator at `state`."""
    g = torch.Generator(device=device)
    g.set_state(state)
    Fr, J = model_cfg["num_frames"], model_cfg["num_joints"]
    t = torch.randint(0, timesteps, (B,), generator=g, device=device)
    noise = torch.randn((B, Fr, J, 3), generator=g, device=device)
    masks = {}
    for i, rate in enumerate(droppath_rates(model_cfg)):
        rate = float(rate)
        for kind, per in (("ste", Fr), ("tte", J)):
            if rate <= 0.0:
                continue
            keep = 1.0 - rate
            masks[f"{kind}_{i}"] = tuple(
                torch.where(torch.rand(B * per, generator=g, device=device) < keep,
                            1.0 / keep, 0.0) for _ in range(2))
    return t, noise, masks


def loss_fn(model, x2d, x3d, weights, t, noise, masks, diff, keep_rows=None,
            mm=torch.matmul):
    """The masked MPJPE of one step on root-zeroed x3d: mean over the rows
    of weight 1 (all rows, or `keep_rows` of them: a planted fault)."""
    dt = model.Spatial_pos_embed.dtype
    x3d = x3d.to(dt).clone()
    x3d[:, :, 0] = 0.0
    x = diffusion.noisy_pose(x3d, t, noise, diff)
    pred = model(x2d.to(dt), x, t, masks=masks, mm=mm) * diff["unit_scale"]
    err = torch.linalg.vector_norm(pred - x3d, dim=-1)  # (B, F, J)
    w = weights.to(dt)
    if keep_rows is not None:
        w = w.clone()
        w[keep_rows:] = 0
    return (err * w[:, None, None]).sum() / (w.sum() * err.shape[1] * err.shape[2])


def run_steps(model, batches, step_draws, diff, lr, weight_decay, keep_rows=None,
              mm=torch.matmul):
    """Train `model` through the batches [(x2d, x3d, weights)] with their
    draws [(t, noise, masks)]. Returns (losses [float], the first step's
    gradients {name: tensor}, the parameters after the last step {name:
    tensor}); the model is trained in place."""
    params = dict(model.named_parameters())
    opt = torch.optim.AdamW(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)
    losses, first_grads = [], None
    for (x2d, x3d, w), (t, noise, masks) in zip(batches, step_draws):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, x2d, x3d, w, t, noise, masks, diff, keep_rows, mm)
        loss.backward()
        if first_grads is None:
            first_grads = {k: p.grad.detach().clone() for k, p in params.items()}
        opt.step()
        losses.append(float(loss.detach()))
    return losses, first_grads, {k: p.detach().clone() for k, p in params.items()}

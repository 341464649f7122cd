"""D3DP's training step in plain PyTorch: the noised forward with DropPath,
the masked MPJPE loss and AdamW (main.py's train loop: AdamW lr 6e-5,
weight decay 0.1 on every parameter, betas 0.9 and 0.999, eps 1e-8). A
step's random draws (t, the noise, the DropPath masks) are the
architecture's `step_draws` (port_bench/arch/).
"""

import torch

from port_bench.reference import diffusion


def loss_fn(model, x2d, x3d, weights, t, noise, masks, diff, keep_rows=None,
            mm=torch.matmul):
    """The masked MPJPE of one step on root-zeroed x3d: mean over the rows
    of weight 1 (all rows, or `keep_rows` of them: a planted fault)."""
    dt = next(model.parameters()).dtype
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

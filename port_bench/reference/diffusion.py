"""D3DP's diffusion around the denoiser, in plain PyTorch: the cosine
schedule, DDIM sampling of H hypotheses with flip test-time augmentation
(D3DP's common/diffusionpose.py, ddim_sample), and the training
forward's noising (prepare_targets).

Kept as D3DP states them: the noisy pose clamped to +-1.1*scale before the
model and the x0 prediction clamped to it after the flip average; eta = 1
with fresh noise on every step; all K steps' x0 predictions returned.
The schedule is float64 throughout.
"""

import numpy as np
import torch


def cosine_alphas_cumprod(timesteps, s=0.008):
    """alphas_cumprod (T,) of the cosine schedule (Nichol and Dhariwal),
    betas clipped to [0, 0.999]."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.999)
    return np.cumprod(1.0 - betas)


def ddim_steps(timesteps, k, eta=1.0):
    """The K DDIM steps: [(t, sqrt(1/a), sqrt(1/a - 1), sqrt(a_next), c,
    sigma, last)] with times linspace(-1, T-1, K+1) truncated, descending."""
    ac = cosine_alphas_cumprod(timesteps)
    times = list(reversed(np.linspace(-1, timesteps - 1, k + 1).astype(np.int64).tolist()))
    out = []
    for t, tn in zip(times[:-1], times[1:]):
        a = ac[t]
        if tn < 0:
            out.append((t, np.sqrt(1 / a), np.sqrt(1 / a - 1), 0.0, 0.0, 0.0, True))
            continue
        an = ac[tn]
        sigma = eta * np.sqrt((1 - a / an) * (1 - an) / (1 - a))
        out.append((t, np.sqrt(1 / a), np.sqrt(1 / a - 1), np.sqrt(an),
                    np.sqrt(1 - an - sigma ** 2), sigma, False))
    return out


def flip_pose(x, joints_left, joints_right):
    """The mirrored pose: x coordinate negated, left and right joints
    swapped. x: (..., J, C)."""
    perm = list(range(x.shape[-2]))
    for a, b in zip(joints_left, joints_right):
        perm[a], perm[b] = b, a
    sign = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
    sign[0] = -1
    return (x * sign)[..., perm, :]


@torch.no_grad()
def sample(model, x2d, x2d_flip, img0, step_noises, diff, joints_left, joints_right,
           mm=torch.matmul):
    """DDIM-sample H hypotheses of each window.

    x2d, x2d_flip: (B, F, J, 2); img0: (B, H, F, J, 3); step_noises: (K, B,
    H, F, J, 3); diff: the configuration's "diffusion" (timesteps, scale,
    unit_scale, eta, flip_tta). Returns (B, K, H, F, J, 3) in the model's
    dtype and the dataset's units.
    """
    dt = next(model.parameters()).dtype
    B, H = img0.shape[:2]
    K = step_noises.shape[0]
    scale = diff["scale"]
    flip = diff["flip_tta"]
    x2d, x2d_flip = x2d.to(dt), x2d_flip.to(dt)
    img0, step_noises = img0.to(dt), step_noises.to(dt)

    def rows(x):  # (B, ...) -> (B*H, ...), window-major
        return x[:, None].expand(B, H, *x.shape[1:]).reshape(B * H, *x.shape[1:])

    cond = rows(x2d)
    if flip:
        cond = torch.cat([cond, rows(x2d_flip)])
    img = img0
    preds = []
    for k, (t, r, rm1, an, c, sigma, last) in enumerate(ddim_steps(diff["timesteps"], K,
                                                                   diff["eta"])):
        x = (torch.clamp(img, -1.1 * scale, 1.1 * scale) / scale).reshape(B * H, *img.shape[2:])
        if flip:
            x = torch.cat([x, flip_pose(x, joints_left, joints_right)])
        tv = torch.full((x.shape[0],), t, dtype=torch.long, device=x.device)
        pred = model(cond, x, tv, mm=mm).to(dt)
        if flip:
            pn, pf = pred.chunk(2)
            pred = (pn + flip_pose(pf, joints_left, joints_right)) / 2
        pred = pred.reshape(img.shape)
        x_start = torch.clamp(pred * scale, -1.1 * scale, 1.1 * scale)
        if last:
            img = x_start
        else:
            eps = (r * img - x_start) / rm1
            img = x_start * an + c * eps + sigma * step_noises[k]
        preds.append(x_start)
    return torch.stack(preds, dim=1) * diff["unit_scale"]


def noisy_pose(x3d, t, noise, diff):
    """The training forward's input: x3d (B,F,J,3) in the dataset's units,
    noised to step t (B,) with `noise`, clamped, in the model's scale."""
    ac = torch.as_tensor(cosine_alphas_cumprod(diff["timesteps"]), dtype=x3d.dtype,
                         device=x3d.device)[t]
    scale = diff["scale"]
    x0 = x3d / diff["unit_scale"] * scale
    x = (ac.sqrt()[:, None, None, None] * x0
         + (1 - ac).sqrt()[:, None, None, None] * noise.to(x3d.dtype))
    return torch.clamp(x, -1.1 * scale, 1.1 * scale) / scale

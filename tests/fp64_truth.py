"""A float64 statement of the evaluation path, for
tests/test_torch_fp64_truth.py: the ground truth that the fp32 paths (the
JAX package, the port in one process, the port's tensor-parallel split)
are measured against.

Written from the math alone, in `torch.float64` on the CPU, with nothing of
the port's ops or model, so that it stays independent of the code under
test:

* `model`: MixSTE2 at level-0 math (pre-LN blocks; LN eps 1e-6 in the
  blocks and 1e-5 in the head; exact-erf GELU; one shared spatial and one
  shared temporal norm after every depth; the temporal position embedding
  added once, after the first spatial block), from a state_dict in the
  original PyTorch names (`d3dp_tpu_torch.train.convert.state_dict_from_flax`
  of the JAX parameters, cast by `weights64`);
* `sample`: D3DP's DDIM loop (eta=1 with the injected noise on every step,
  the +-1.1*scale clamp on both sides of the model, the flip average before
  the x_start clamp), its schedule recomputed here in float64;
* `score`: the four modes of `Evaluator._score` on one micro-batch (P-Best,
  P-Agg, J-Best, J-Agg with JPMA's 2D reprojection through the H36M
  distortion), with the selections each mode made;
* `micro_batches` / `evaluate`: the Evaluator's loop (the flipped
  conditioning, the windows with the right-aligned last one, micro-batches
  padded with row 0 at weight 0, replay noise zero-padded), the modes
  averaged over micro-batches weighted by their frames, in mm.

The injected noise is the fp32 arrays the parity tests use, which float64
holds exactly.
"""

import math

import numpy as np
import torch

F64 = torch.float64
BLOCK_EPS, HEAD_EPS = 1e-6, 1e-5
MODES = ("J_Best", "P_Best", "P_Agg", "J_Agg")


def weights64(state_dict):
    """{name: float64 tensor} of a state_dict (tensors or arrays)."""
    return {k: torch.as_tensor(np.array(v)).to(F64) for k, v in state_dict.items()}


# ------------------------------------------------------------------- model
def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def linear(P, name, x):
    return x @ P[f"{name}.weight"].T + P[f"{name}.bias"]


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def time_embedding(t, dim):
    """Sinusoidal embedding of the timesteps t (B,) -> (B, dim)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=F64) * -(math.log(10000.0) / (half - 1)))
    args = torch.as_tensor(t).to(F64)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def attention(P, name, x, heads, scale):
    R, N, C = x.shape
    qkv = linear(P, f"{name}.qkv", x).reshape(R, N, 3, heads, C // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)  # (R, h, N, d) each
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    o = (p @ v).permute(0, 2, 1, 3).reshape(R, N, C)
    return linear(P, f"{name}.proj", o)


def block(P, name, x, heads, scale):
    x = x + attention(P, f"{name}.attn",
                      layer_norm(x, P[f"{name}.norm1.weight"], P[f"{name}.norm1.bias"],
                                 BLOCK_EPS), heads, scale)
    h = layer_norm(x, P[f"{name}.norm2.weight"], P[f"{name}.norm2.bias"], BLOCK_EPS)
    return x + linear(P, f"{name}.mlp.fc2", gelu(linear(P, f"{name}.mlp.fc1", h)))


def model(P, cfg, x2d, x3d, t):
    """MixSTE2's forward: x2d (B, F, J, 2), x3d (B, F, J, 3), t (B,) ->
    (B, F, J, 3). cfg: depth, num_heads (a MixSTEConfig or a dict)."""
    depth, heads = _get(cfg, "depth"), _get(cfg, "num_heads")
    B, Fr, J, _ = x3d.shape
    x = linear(P, "Spatial_patch_to_embedding", torch.cat([x2d, x3d], dim=-1))
    C = x.shape[-1]
    scale = (C // heads) ** -0.5
    temb = linear(P, "time_mlp.3", gelu(linear(P, "time_mlp.1", time_embedding(t, C))))
    x = x + P["Spatial_pos_embed"] + temb[:, None, None, :]
    h = x.reshape(B * Fr, J, C)
    for i in range(depth):
        h = block(P, f"STEblocks.{i}", h, heads, scale)
        h = layer_norm(h, P["Spatial_norm.weight"], P["Spatial_norm.bias"], BLOCK_EPS)
        h = h.reshape(B, Fr, J, C).transpose(1, 2).reshape(B * J, Fr, C)
        if i == 0:
            h = h + P["Temporal_pos_embed"]
        h = block(P, f"TTEblocks.{i}", h, heads, scale)
        h = layer_norm(h, P["Temporal_norm.weight"], P["Temporal_norm.bias"], BLOCK_EPS)
        h = h.reshape(B, J, Fr, C).transpose(1, 2).reshape(B * Fr, J, C)
    x = layer_norm(h.reshape(B, Fr, J, C), P["head.0.weight"], P["head.0.bias"], HEAD_EPS)
    return linear(P, "head.1", x)


def _get(cfg, key):
    return cfg[key] if isinstance(cfg, dict) else getattr(cfg, key)


# ----------------------------------------------------------------- sampler
def ddim_steps(K, timesteps=1000, eta=1.0, s=0.008):
    """The K DDIM steps' (t, coefficients) in float64: the cosine schedule
    and the (time, time_next) pairs of linspace(-1, T-1, K+1)."""
    x = np.linspace(0, timesteps, timesteps + 1, dtype=np.float64)
    ac = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    ac = ac / ac[0]
    betas = np.clip(1 - ac[1:] / ac[:-1], 0, 0.999)
    ac = np.cumprod(1.0 - betas)
    times = list(reversed(np.linspace(-1, timesteps - 1, K + 1).astype(np.int64).tolist()))
    out = []
    for time, nxt in zip(times[:-1], times[1:]):
        c = dict(t=time, recip=np.sqrt(1.0 / ac[time]), recipm1=np.sqrt(1.0 / ac[time] - 1.0),
                 last=nxt < 0)
        if nxt >= 0:
            a, an = ac[time], ac[nxt]
            sigma = eta * np.sqrt((1 - a / an) * (1 - an) / (1 - a))
            c.update(an_sqrt=np.sqrt(an), c=np.sqrt(1 - an - sigma ** 2), sigma=sigma)
        out.append(c)
    return out


def lr_perm(num_joints, left, right):
    perm = np.arange(num_joints)
    perm[list(left)] = right
    perm[list(right)] = left
    return torch.as_tensor(perm)


def flip_pose(x, perm):
    x = x.clone()
    x[..., 0] = -x[..., 0]
    return x[..., perm, :]


def sample(P, cfg, x2d, x2d_flip, img0, step_noises, perm, scale=1.0, unit_scale=1.0):
    """D3DP.sample with flip-TTA on the injected noise: x2d, x2d_flip (B, F,
    J, 2), img0 (B, H, F, J, 3), step_noises (K, B, H, F, J, 3), perm the
    left/right joint swap -> every step's x_start (B, K, H, F, J, 3)."""
    x2d, x2d_flip, img, step_noises = (torch.as_tensor(np.array(a)).to(F64)
                                       for a in (x2d, x2d_flip, img0, step_noises))
    B, H, Fr, J, _ = img.shape
    K = step_noises.shape[0]

    def fold(x):
        return x[:, None].expand(B, H, *x.shape[1:]).reshape(B * H, *x.shape[1:])

    cond = torch.cat([fold(x2d), fold(x2d_flip)], dim=0)
    preds = []
    for k, c in enumerate(ddim_steps(K)):
        x = (torch.clamp(img, -1.1 * scale, 1.1 * scale) / scale).reshape(B * H, Fr, J, 3)
        x = torch.cat([x, flip_pose(x, perm)], dim=0)
        pred = model(P, cfg, cond, x, torch.full((2 * B * H,), c["t"]))
        pred_n, pred_f = pred.chunk(2, dim=0)
        pred = ((pred_n + flip_pose(pred_f, perm)) / 2).reshape(B, H, Fr, J, 3)
        x_start = torch.clamp(pred * scale, -1.1 * scale, 1.1 * scale)
        if c["last"]:
            img = x_start
        else:
            noise = (c["recip"] * img - x_start) / c["recipm1"]
            img = x_start * c["an_sqrt"] + c["c"] * noise + c["sigma"] * step_noises[k]
        preds.append(x_start)
    return torch.stack(preds, dim=1) * unit_scale


# ------------------------------------------------------------------ scoring
def project_to_2d(X, cam):
    """Camera-space points X (N, ..., 3) -> pixels (N, ..., 2) through the
    H36M intrinsics cam (N, 9): focal, centre, radial k1-3, tangential p1-2."""
    cam = cam.reshape(cam.shape[0], *([1] * (X.dim() - 2)), 9)
    f, c, k, p = cam[..., :2], cam[..., 2:4], cam[..., 4:7], cam[..., 7:]
    XX = torch.clamp(X[..., :2] / X[..., 2:], -1.0, 1.0)
    r2 = XX.square().sum(-1, keepdim=True)
    radial = 1 + (k * torch.cat([r2, r2 ** 2, r2 ** 3], dim=-1)).sum(-1, keepdim=True)
    tan = (p * XX).sum(-1, keepdim=True)
    return f * (XX * (radial + tan) + p * r2) + c


def score(preds, x2d, x3d, traj, cam, selections=None):
    """The four modes of one micro-batch of real rows, in metres, -> ({mode:
    (K,) float64 array}, the selections): preds (B, K, H, F, J, 3) (any
    dtype, taken to float64), x2d (B, F, J, 2), x3d (B, F, J, 3) root-zeroed,
    traj (B, F, 1, 3), cam (B, 9). The selections are P-Best's hypothesis a
    step (K,) and JPMA's per-joint hypothesis (B, K, F, J); given, they
    replace the ones these predictions would make."""
    preds, x2d, x3d, traj, cam = (torch.as_tensor(np.array(a)).to(F64)
                                  for a in (preds, x2d, x3d, traj, cam))
    preds[..., 0, :] = 0.0
    B, K, H, Fr, J, _ = preds.shape
    err = torch.linalg.vector_norm(preds - x3d[:, None, None], dim=-1)  # (B, K, H, F, J)
    per_kh = err.mean(dim=(0, 3, 4))
    reproj = project_to_2d((preds + traj[:, None, None]).reshape(B, -1, 3), cam)
    err2d = torch.linalg.vector_norm(reproj.reshape(B, K, H, Fr, J, 2) - x2d[:, None, None],
                                     dim=-1)
    own = dict(p_best=per_kh.argmin(dim=1), jpma=err2d.argmin(dim=2))
    sel = own if selections is None else selections
    mean_pose = preds.mean(dim=2)
    modes = dict(
        J_Best=err.amin(dim=2).mean(dim=(0, 2, 3)),
        P_Best=per_kh.gather(1, sel["p_best"][:, None])[:, 0],
        P_Agg=torch.linalg.vector_norm(mean_pose - x3d[:, None], dim=-1).mean(dim=(0, 2, 3)),
        J_Agg=err.gather(2, sel["jpma"][:, :, None]).squeeze(2).mean(dim=(0, 2, 3)))
    return {m: v.numpy() for m, v in modes.items()}, own


# --------------------------------------------------------- the evaluator loop
def window_sequence(seq, rf):
    """(T, ...) -> (W, rf, ...): consecutive windows, the last right-aligned
    (a sequence shorter than rf edge-padded)."""
    T = seq.shape[0]
    n = max(T // rf + (1 if T % rf else 0), 1)
    if T < rf:
        seq = np.pad(seq, [(0, rf - T)] + [(0, 0)] * (seq.ndim - 1), mode="edge")
    return np.stack([seq[i * rf:(i + 1) * rf] for i in range(n - 1)] + [seq[-rf:]])


def micro_batches(data, rf, bs, kps_left, kps_right, noise_provider):
    """The Evaluator's micro-batches of (cams, poses_3d, poses_2d): dicts of
    numpy fp32 x2d, x2d_flip, x3d (root-zeroed), traj, cam, weights, img0
    and step_noises, each padded to bs rows as the Evaluator pads them, and
    n, the real rows."""
    for cam, p3, p2 in zip(*data):
        p2 = np.asarray(p2, np.float32)
        p2f = p2.copy()
        p2f[..., 0] *= -1
        p2f[:, kps_left + kps_right] = p2f[:, kps_right + kps_left]
        w2d, w2d_f, w3d = (window_sequence(a, rf) for a in (p2, p2f, np.asarray(p3, np.float32)))
        traj = w3d[:, :, :1].copy()
        w3d = w3d.copy()
        w3d[:, :, 0] = 0.0
        for lo in range(0, len(w2d), bs):
            n = min(bs, len(w2d) - lo)
            pad = bs - n

            def take(a):
                x = a[lo:lo + n]
                return np.concatenate([x, np.repeat(x[:1], pad, 0)]) if pad else x

            img0, steps = noise_provider(n)
            z = ((0, pad),) + ((0, 0),) * (img0.ndim - 1)
            yield dict(x2d=take(w2d), x2d_flip=take(w2d_f), x3d=take(w3d), traj=take(traj),
                       cam=np.tile(np.asarray(cam, np.float32), (bs, 1)),
                       weights=np.concatenate([np.ones(n), np.zeros(pad)]).astype(np.float32),
                       img0=np.pad(img0, z), step_noises=np.pad(steps, ((0, 0),) + z), n=n)


def evaluate(P, cfg, batches, perm):
    """The four modes (mm, (K,) float64 each) over the micro-batches, the
    Evaluator's frame-weighted mean of their means, and per micro-batch the
    real rows' predictions and selections."""
    sums, total, per_batch = {m: 0.0 for m in MODES}, 0, []
    for b in batches:
        n = b["n"]
        preds = sample(P, cfg, b["x2d"][:n], b["x2d_flip"][:n], b["img0"][:n],
                       b["step_noises"][:, :n], perm)
        modes, sel = score(preds, b["x2d"][:n], b["x3d"][:n], b["traj"][:n], b["cam"][:n])
        for m in MODES:
            sums[m] = sums[m] + modes[m] * n
        total += n
        per_batch.append(dict(preds=preds, selections=sel, modes=modes))
    return {m: sums[m] / total * 1000.0 for m in MODES}, per_batch

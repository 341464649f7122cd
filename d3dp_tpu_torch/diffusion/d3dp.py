"""D3DP diffusion wrapper: the x0-predicting training forward and DDIM
sampling of H pose hypotheses.

Counterpart of d3dp_tpu/diffusion/d3dp.py on its training forward and its
sampling path, with DDIM feature reuse (reference:
common/diffusionpose.py:55-320). The H hypotheses and the flip-TTA copy are
folded into one batch, so each DDIM step is one MixSTE2 forward. The K-step
loop is a Python loop (it stands in for the JAX package's `lax.scan` and,
under reuse, its `lax.cond`); all randomness comes from an explicit
torch.Generator or from `noise_override` / `t_noise_override`.

Reference semantics kept (they affect metric parity):
  * clamp to +-1.1*scale on both x_t and x_start
  * eta=1 with fresh noise injected on every DDIM step
  * flip-TTA averaging BEFORE the x_start clamp
  * all K intermediate x0 predictions returned, stacked at dim 1
  * per-sample random t and noise in training
"""

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np
import torch

from d3dp_tpu_torch.device import resolve_device
from d3dp_tpu_torch.diffusion.schedule import CosineSchedule
from d3dp_tpu_torch.models.mixste import MixSTE2, MixSTEConfig
from d3dp_tpu_torch.utils import profiling


def flip_pose(x, perm):
    """Mirror a pose: negate the x coordinate, swap left/right joints.
    x: (..., J, C); perm: (J,) index tensor. (reference:
    common/diffusionpose.py:150-153)"""
    # the scalar's copy into a device tensor waits for the device
    with profiling.span("flip_pose", sync=True):
        profiling.count("host_syncs")
        sign = torch.ones(x.shape[-1], dtype=x.dtype, device=x.device)
        sign[0] = -1.0
    return torch.index_select(x * sign, x.dim() - 2, perm)


def reuse_schedule(n_steps, interval):
    """Which DDIM steps run the full model under feature reuse, (n_steps,)
    bool: every `interval`-th step, and always the last, whose x_start is
    the headline prediction."""
    steps = np.arange(n_steps)
    return (steps % interval == 0) | (steps == n_steps - 1)


def make_lr_perm(num_joints, joints_left, joints_right):
    """Permutation swapping left/right joint indices."""
    perm = np.arange(num_joints)
    perm[list(joints_left)] = joints_right
    perm[list(joints_right)] = joints_left
    return perm


@dataclass(frozen=True)
class D3DPConfig:
    model: MixSTEConfig = field(default_factory=MixSTEConfig)
    timesteps: int = 1000
    sampling_timesteps: int = 5
    num_proposals: int = 1
    scale: float = 1.0
    eta: float = 1.0
    flip_tta: bool = True
    unit_scale: float = 1.0  # 1.0 for H36M (metres), 1000.0 for 3DHP (mm)
    # DDIM feature reuse (FRDiff-style, arXiv:2312.03517): the full model runs
    # on the steps of `reuse_schedule` and caches the deep block pairs'
    # contribution to the stream; the steps between run only the first
    # `reuse_tap` pairs and add it. interval <= 1 is off (the default).
    # reuse_tau > 0 also refreshes whenever the noisy pose has drifted more
    # than tau (relative L2 against the last refresh, max over the batch).
    reuse_interval: int = 1
    reuse_tap: int = 2
    reuse_tau: float = 0.0
    joints_left: Tuple[int, ...] = (4, 5, 6, 11, 12, 13)
    joints_right: Tuple[int, ...] = (1, 2, 3, 14, 15, 16)


class D3DP:
    """Config + schedule + the MixSTE2 denoiser it samples with.

    `model` defaults to a MixSTE2 with weights from `seed`, on `device`
    (default: the card; see `resolve_device`)."""

    def __init__(self, cfg: D3DPConfig, model=None, device=None, seed=0):
        self.cfg = cfg
        self.device = resolve_device(device) if model is None else \
            next(model.parameters()).device
        self.model = model if model is not None else MixSTE2(cfg.model, self.device, seed)
        self.model.eval()
        self.schedule = CosineSchedule(cfg.timesteps)
        self._lr_perm = torch.as_tensor(
            make_lr_perm(cfg.model.num_joints, cfg.joints_left, cfg.joints_right),
            device=self.device)
        # fp32 device copies of the (host fp64) tables of the training-time
        # q_sample gather
        self._sqrt_ac = torch.as_tensor(self.schedule.sqrt_alphas_cumprod,
                                        dtype=torch.float32, device=self.device)
        self._sqrt_1mac = torch.as_tensor(self.schedule.sqrt_one_minus_alphas_cumprod,
                                          dtype=torch.float32, device=self.device)

    def train_forward(self, x2d, x3d, train=True, generator=None, t_noise_override=None,
                      droppath_masks=None, module=None):
        """Denoise a q-sampled pose; returns the x0 prediction (B, F, J, 3)
        with autograd (reference: prepare_targets + the train branch of
        forward, diffusionpose.py:279-320): per-sample random t and noise.

        t, the noise and the DropPath masks are drawn from `generator` (a
        torch.Generator on the model's device); `t_noise_override=(t, noise)`
        replaces the first two draws and `droppath_masks` the masks
        (deterministic replay and parity tests; see MixSTE2.forward).
        `module` runs the denoiser in place of `self.model` (a data-parallel
        step's DistributedDataParallel wrapper of it).

        train=False is the JAX `deterministic=True` forward, which there runs
        the fused stages with their custom backward. Here it is the composed
        path without DropPath: the same function, and it has a backward,
        which the fused eval flow has not.
        """
        cfg = self.cfg
        dev = self.device
        B = x3d.shape[0]
        x2d = torch.as_tensor(x2d, dtype=torch.float32, device=dev)
        x3d = torch.as_tensor(x3d, dtype=torch.float32, device=dev) / cfg.unit_scale
        if t_noise_override is not None:
            profiling.count_uploads(dev, *t_noise_override)
            t = torch.as_tensor(t_noise_override[0], device=dev).long()
            noise = torch.as_tensor(t_noise_override[1], dtype=torch.float32, device=dev)
        elif generator is None:
            raise ValueError("train_forward needs a torch.Generator or t_noise_override")
        else:
            t, noise = self.train_noise(B, generator)

        x_start = x3d * cfg.scale
        x = (self._sqrt_ac[t][:, None, None, None] * x_start
             + self._sqrt_1mac[t][:, None, None, None] * noise)
        x = torch.clamp(x, -1.1 * cfg.scale, 1.1 * cfg.scale) / cfg.scale
        pred = (module or self.model)(x2d, x, t, train=True, generator=generator,
                                      droppath_masks=droppath_masks, drop_path=train)
        return pred * cfg.unit_scale

    def train_noise(self, B, generator):
        """The training forward's draws for a batch of B: t (B,) and the
        noise (B, F, J, 3), from `generator` in train_forward's order. A
        data-parallel rank draws them for the global batch and keeps its
        rows, so its run draws what one device's run draws."""
        m = self.cfg.model
        t = torch.randint(0, self.cfg.timesteps, (B,), generator=generator, device=self.device)
        noise = torch.randn((B, m.num_frames, m.num_joints, 3), generator=generator,
                            device=self.device)
        return t, noise

    def sample_noise(self, B, generator, num_proposals=None, sampling_timesteps=None):
        """`sample`'s draws for a batch of B: img0 (B, H, F, J, 3) and the
        step noises (K, B, H, F, J, 3), from `generator` in sample's order
        (drawn for the global batch on a data-parallel rank, as
        train_noise); H and K as `sample` takes them."""
        cfg, m = self.cfg, self.cfg.model
        H = num_proposals or cfg.num_proposals
        K = sampling_timesteps or cfg.sampling_timesteps
        shape = (B, H, m.num_frames, m.num_joints, 3)
        img0 = torch.randn(shape, generator=generator, device=self.device)
        step_noises = torch.randn((K, *shape), generator=generator, device=self.device)
        return img0, step_noises

    @torch.inference_mode()
    def sample(self, x2d, x2d_flip=None, generator=None, noise_override=None,
               num_proposals=None, sampling_timesteps=None):
        """DDIM-sample H hypotheses, returning all K intermediate x0 preds.

        x2d: (B, F, J, 2); x2d_flip: its keypoint-symmetry-flipped copy
        (required with cfg.flip_tta). Returns (B, K, H, F, J, 3) fp32 in the
        dataset's units (unit_scale applied). H and K are this call's
        `num_proposals` and `sampling_timesteps`, by default the config's.

        Noise is drawn from `generator` (a torch.Generator on the sampler's
        device) unless `noise_override=(img0, step_noises)` gives img0
        (B,H,F,J,3) and step_noises (K,B,H,F,J,3) -- deterministic replay and
        parity tests (the last step's noise is multiplied by sigma=0).
        """
        with profiling.span("sample", device=self.device):
            return self._sample(x2d, x2d_flip, generator, noise_override, num_proposals,
                                sampling_timesteps)

    def _sample(self, x2d, x2d_flip, generator, noise_override, num_proposals,
                sampling_timesteps):
        cfg = self.cfg
        H = num_proposals or cfg.num_proposals
        K = sampling_timesteps or cfg.sampling_timesteps
        B, Fr, J, _ = x2d.shape
        dev = self.device
        flip = cfg.flip_tta
        if flip and x2d_flip is None:
            raise ValueError("flip_tta requires x2d_flip")
        scale = cfg.scale
        f32 = torch.float32

        if noise_override is not None:
            profiling.count_uploads(dev, *noise_override)
            img0 = torch.as_tensor(noise_override[0], dtype=f32, device=dev)
            step_noises = torch.as_tensor(noise_override[1], dtype=f32, device=dev)
        elif generator is None:
            raise ValueError("sample needs a torch.Generator or noise_override")
        else:
            img0, step_noises = self.sample_noise(B, generator, H, K)

        def fold(x):  # (B,F,J,C) -> (B*H,F,J,C), each window repeated H times
            x = torch.as_tensor(x, dtype=f32, device=dev)
            return x[:, None].expand(B, H, *x.shape[1:]).reshape(B * H, *x.shape[1:])

        cond = fold(x2d)
        if flip:
            cond = torch.cat([cond, fold(x2d_flip)], dim=0)
        perm = self._lr_perm

        def denoise(img, t, **reuse):
            """One flip-fused model evaluation -> x0 prediction (B,H,F,J,3);
            with `reuse` (reuse_tap=, deep_delta=) the model's reuse call,
            and on a full call (x0 prediction, delta)."""
            x = (torch.clamp(img, -1.1 * scale, 1.1 * scale) / scale).reshape(B * H, Fr, J, 3)
            if flip:
                x = torch.cat([x, flip_pose(x, perm)], dim=0)
            t_vec = torch.full((x.shape[0],), t, dtype=torch.int32, device=dev)
            pred = self.model(cond, x, t_vec, **reuse)
            delta = None
            if isinstance(pred, tuple):
                pred, delta = pred
            if flip:
                pred_n, pred_f = pred.chunk(2, dim=0)
                pred = (pred_n + flip_pose(pred_f, perm)) / 2
            pred = pred.reshape(B, H, Fr, J, 3)
            return pred if delta is None else (pred, delta)

        reuse = cfg.reuse_interval > 1
        full_steps = reuse_schedule(K, cfg.reuse_interval)
        delta, img_ref = None, img0  # the cached delta and the pose it was taken at

        def refresh(img, k):
            """Under reuse: whether step k runs the full model."""
            if full_steps[k]:
                return True
            if cfg.reuse_tau <= 0:
                return False
            drift = (torch.linalg.vector_norm((img - img_ref).reshape(B * H, -1), dim=-1)
                     / (torch.linalg.vector_norm(img_ref.reshape(B * H, -1), dim=-1) + 1e-8))
            profiling.count("host_syncs")
            return bool(drift.max() > cfg.reuse_tau)

        consts = self.schedule.ddim_step_constants(K, cfg.eta)
        img = img0
        preds = []
        for k in range(K):
            with profiling.span("sample.step", unit=k, device=dev):
                c = {name: float(v[k]) for name, v in consts.items()}  # fp32 values
                t = int(consts["t"][k])
                if not reuse:
                    pred = denoise(img, t)
                elif refresh(img, k):
                    pred, delta = denoise(img, t, reuse_tap=cfg.reuse_tap)
                    img_ref = img
                else:
                    pred = denoise(img, t, reuse_tap=cfg.reuse_tap, deep_delta=delta)
                x_start = torch.clamp(pred * scale, -1.1 * scale, 1.1 * scale)
                if c["is_last"] > 0:
                    img = x_start
                else:
                    pred_noise = (c["sqrt_recip_ac"] * img - x_start) / c["sqrt_recipm1_ac"]
                    img = (x_start * c["alpha_next_sqrt"] + c["c"] * pred_noise
                           + c["sigma"] * step_noises[k])
                preds.append(x_start)
        return torch.stack(preds, dim=1) * cfg.unit_scale

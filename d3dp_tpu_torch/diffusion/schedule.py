"""Diffusion schedule math.

The cosine beta schedule and every derived quantity are computed once,
host-side, in float64 numpy (matching the reference's float64 buffers,
common/diffusionpose.py:42-117). All K DDIM step coefficients are also
precomputed host-side; the sampler's Python loop reads one scalar per step.
"""

from dataclasses import dataclass, field

import numpy as np


def cosine_beta_schedule(timesteps: int, s: float = 0.008) -> np.ndarray:
    """Cosine schedule of Nichol & Dhariwal. float64, shape (T,).

    (reference: common/diffusionpose.py:42-52)
    """
    steps = timesteps + 1
    x = np.linspace(0, timesteps, steps, dtype=np.float64)
    alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
    alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
    betas = 1 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
    return np.clip(betas, 0, 0.999)


def ddim_time_pairs(total_timesteps: int, sampling_timesteps: int):
    """DDIM (time, time_next) pairs, descending, ending at (.., -1).

    Times come from linspace(-1, T-1, K+1) truncated to ints, reversed —
    identical to the reference (common/diffusionpose.py:178-180, :221-223).
    """
    times = np.linspace(-1, total_timesteps - 1, sampling_timesteps + 1)
    times = list(reversed(times.astype(np.int64).tolist()))
    return list(zip(times[:-1], times[1:]))


@dataclass(frozen=True)
class CosineSchedule:
    """All schedule-derived constants, float64 numpy, computed at build time."""

    timesteps: int
    s: float = 0.008
    betas: np.ndarray = field(init=False)
    alphas_cumprod: np.ndarray = field(init=False)
    alphas_cumprod_prev: np.ndarray = field(init=False)
    sqrt_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_one_minus_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_recip_alphas_cumprod: np.ndarray = field(init=False)
    sqrt_recipm1_alphas_cumprod: np.ndarray = field(init=False)
    posterior_variance: np.ndarray = field(init=False)

    def __post_init__(self):
        betas = cosine_beta_schedule(self.timesteps, self.s)
        alphas = 1.0 - betas
        alphas_cumprod = np.cumprod(alphas)
        alphas_cumprod_prev = np.concatenate([[1.0], alphas_cumprod[:-1]])
        object.__setattr__(self, "betas", betas)
        object.__setattr__(self, "alphas_cumprod", alphas_cumprod)
        object.__setattr__(self, "alphas_cumprod_prev", alphas_cumprod_prev)
        object.__setattr__(self, "sqrt_alphas_cumprod", np.sqrt(alphas_cumprod))
        object.__setattr__(
            self, "sqrt_one_minus_alphas_cumprod", np.sqrt(1.0 - alphas_cumprod)
        )
        object.__setattr__(
            self, "sqrt_recip_alphas_cumprod", np.sqrt(1.0 / alphas_cumprod)
        )
        object.__setattr__(
            self, "sqrt_recipm1_alphas_cumprod", np.sqrt(1.0 / alphas_cumprod - 1.0)
        )
        object.__setattr__(
            self,
            "posterior_variance",
            betas * (1.0 - alphas_cumprod_prev) / (1.0 - alphas_cumprod),
        )

    def ddim_step_constants(self, sampling_timesteps: int, eta: float = 1.0):
        """Per-DDIM-step scalars stacked over K.

        Returns dict of float32 (K,) arrays:
          t            — diffusion timestep fed to the denoiser
          alpha_next_sqrt, c, sigma — DDIM update coefficients
            x_{next} = x0 * alpha_next_sqrt + c * eps_pred + sigma * z
          is_last      — 1.0 where time_next < 0 (update is skipped)
        All computed in float64 then cast. (reference:
        common/diffusionpose.py:229-254)
        """
        pairs = ddim_time_pairs(self.timesteps, sampling_timesteps)
        t_arr, an_sqrt, c_arr, sig_arr, last = [], [], [], [], []
        recip, recipm1 = [], []
        for time, time_next in pairs:
            t_arr.append(time)
            recip.append(self.sqrt_recip_alphas_cumprod[time])
            recipm1.append(self.sqrt_recipm1_alphas_cumprod[time])
            if time_next < 0:
                an_sqrt.append(0.0)
                c_arr.append(0.0)
                sig_arr.append(0.0)
                last.append(1.0)
                continue
            alpha = self.alphas_cumprod[time]
            alpha_next = self.alphas_cumprod[time_next]
            sigma = eta * np.sqrt(
                (1 - alpha / alpha_next) * (1 - alpha_next) / (1 - alpha)
            )
            c = np.sqrt(1 - alpha_next - sigma**2)
            an_sqrt.append(np.sqrt(alpha_next))
            c_arr.append(c)
            sig_arr.append(sigma)
            last.append(0.0)
        f32 = lambda a: np.asarray(a, dtype=np.float32)
        return {
            "t": np.asarray(t_arr, dtype=np.int32),
            "alpha_next_sqrt": f32(an_sqrt),
            "c": f32(c_arr),
            "sigma": f32(sig_arr),
            "is_last": f32(last),
            # for predict_noise_from_start at step time t
            # (reference: common/diffusionpose.py:129-133)
            "sqrt_recip_ac": f32(recip),
            "sqrt_recipm1_ac": f32(recipm1),
        }

"""Windowed multi-hypothesis evaluation.

Counterpart of d3dp_tpu/eval/evaluator.py (reference: main.py:596-794): per
sequence, flip the 2D inputs by keypoint symmetry, window to the receptive
field, micro-batch the windows (padded to a fixed size with 0/1 weights),
DDIM-sample (B,K,H,F,J,3) hypothesis stacks, and score the four
aggregation modes (J-Best, P-Best, P-Agg, J-Agg/JPMA) per micro-batch into
frame-weighted sums. The P1 metrics stay on the device until read.
Protocol-2 runs on host numpy for bit parity with the reference, or with
`p2_device` on the device beside P1 (metrics/procrustes.py).
"""

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from d3dp_tpu_torch.data.prefetch import Prefetcher
from d3dp_tpu_torch.data.windowing import window_sequence
from d3dp_tpu_torch.geometry.camera import project_to_2d
from d3dp_tpu_torch.metrics.mpjpe import (
    mpjpe_diffusion,
    mpjpe_diffusion_all_min,
    mpjpe_diffusion_reproj,
)
from d3dp_tpu_torch.metrics.procrustes import (
    p_mpjpe_diffusion,
    p_mpjpe_diffusion_all_min,
    p_mpjpe_diffusion_reproj,
)
from d3dp_tpu_torch.metrics.procrustes_np import (
    p_mpjpe_diffusion_all_min_np,
    p_mpjpe_diffusion_np,
    p_mpjpe_diffusion_reproj_np,
)

MODES = ("J_Best", "P_Best", "P_Agg", "J_Agg")


def provider_noise(noise_provider, n, pad, bs):
    """Fetch and zero-pad one micro-batch of replay noise. Returns img0
    (bs, H, F, J, 3) and step_noises (K, bs, H, F, J, 3): the step axis
    leads the stack."""
    img0, step_noises = noise_provider(n)
    if pad:
        z = ((0, pad),) + ((0, 0),) * (img0.ndim - 1)
        img0 = np.pad(img0, z)
        step_noises = np.pad(step_noises, ((0, 0),) + z)
    if img0.shape[0] != bs or step_noises.shape[1] != bs:
        raise ValueError(f"noise_provider returned {img0.shape}/{step_noises.shape} "
                         f"for micro-batch size {bs}")
    return img0, step_noises


@dataclass
class EvalResult:
    """Frame-weighted sums per aggregation mode; (K,) arrays.

    add() keeps the error vectors as they come (device tensors, possibly
    still being computed) so the host never waits per micro-batch. They are
    converted once, at read time, in the original sequential float64
    summation order."""

    pending: list = field(default_factory=list)
    pending_p2: list = field(default_factory=list)
    sums: dict = field(default_factory=dict)
    sums_p2: dict = field(default_factory=dict)
    n: int = 0

    def add(self, errors: dict, errors_p2: Optional[dict], weight: int):
        self.pending.append((errors, weight))
        if errors_p2 is not None:
            self.pending_p2.append((errors_p2, weight))
        self.n += weight

    @staticmethod
    def _reduce(pending, sums):
        for errors, weight in pending:
            for m, v in errors.items():
                if isinstance(v, torch.Tensor):
                    v = v.detach().cpu().numpy()
                e = np.asarray(v, dtype=np.float64) * weight
                sums[m] = sums.get(m, 0.0) + e
        pending.clear()
        return sums

    def averages_mm(self):
        """-> dict mode -> (K,) in millimetres."""
        return {m: v / self.n * 1000.0
                for m, v in self._reduce(self.pending, self.sums).items()}

    def averages_p2_mm(self):
        return {m: v / self.n * 1000.0
                for m, v in self._reduce(self.pending_p2, self.sums_p2).items()}


class Evaluator:
    def __init__(self, d3dp, receptive_field=243, batch_size=4, kps_left=None,
                 kps_right=None, p2=False, light=False, quickdebug=False, p2_device=False):
        """`p2` adds Protocol-2 on host numpy. `p2_device=True` (implies p2)
        computes Protocol-2 on the device beside P1 instead, and defers its
        vectors as it does P1's: no host copy per micro-batch. `light=True`
        computes only P-Best (no JPMA reprojection), the reference's
        end-of-epoch validation metric (main.py:455); it takes no P2.
        `quickdebug=True` (the command line's --debug) stops after the first
        micro-batch."""
        if light and (p2 or p2_device):
            raise ValueError("light evaluation computes P-Best only; it takes no p2")
        self.d3dp = d3dp
        self.device = d3dp.device
        self.rf = receptive_field
        self.bs = batch_size
        self.kps_left = kps_left
        self.kps_right = kps_right
        self.p2 = p2 or p2_device
        self.p2_device = p2_device
        self.light = light
        self.quickdebug = quickdebug

    def _score(self, preds, x2d, x3d, traj, cam, weights):
        """All four P1 modes of one micro-batch (P-Best only when light), and
        with p2_device the four P2 modes -> (dict of (K,) tensors, the P2
        dict or None, root-zeroed preds)."""
        preds = preds.clone()
        preds[..., 0, :] = 0.0  # zero root (main.py:700)
        if self.light:
            return {"P_Best": mpjpe_diffusion(preds, x3d, weights=weights)}, None, preds
        B, K, H, F, J, _ = preds.shape
        pred_abs = preds + traj[:, None, None]  # JPMA reprojection (main.py:705-712)
        reproj = project_to_2d(pred_abs.reshape(B, K * H * F * J, 3), cam
                               ).reshape(B, K, H, F, J, 2)
        errors = {
            "J_Best": mpjpe_diffusion_all_min(preds, x3d, weights=weights),
            "P_Best": mpjpe_diffusion(preds, x3d, weights=weights),
            "P_Agg": mpjpe_diffusion_all_min(preds, x3d, mean_pos=True, weights=weights),
            "J_Agg": mpjpe_diffusion_reproj(preds, x3d, reproj, x2d, weights=weights),
        }
        errors_p2 = None
        if self.p2_device:
            errors_p2 = {
                "J_Best": p_mpjpe_diffusion_all_min(preds, x3d, weights=weights),
                "P_Best": p_mpjpe_diffusion(preds, x3d, weights=weights),
                "P_Agg": p_mpjpe_diffusion_all_min(preds, x3d, mean_pos=True, weights=weights),
                "J_Agg": p_mpjpe_diffusion_reproj(preds, x3d, reproj, x2d, weights=weights),
            }
        return errors, errors_p2, preds

    def evaluate(self, generator, rng=None, noise_provider=None, return_predictions=False):
        """Run the eval loop over an UnchunkedGenerator.

        `rng`: torch.Generator on the sampler's device, drawn from in order
        across micro-batches. `noise_provider(n)` (optional) is called once
        per micro-batch with the number of real (unpadded) windows and
        returns (img0, step_noises) of shapes (n,H,F,J,3) and (K,n,H,F,J,3)
        that replace the sampler's draws (pad rows get zeros; their outputs
        carry weight 0).

        Returns an EvalResult; with `return_predictions` (the --render path)
        instead the root-zeroed prediction stack (W, K, H, F, J, 3) numpy of
        all windows of the first sequence, copied to the host once, after
        its last micro-batch. No metric is computed then.
        """
        result = EvalResult()
        rf, bs, dev = self.rf, self.bs, self.device

        def prep():
            """Host-side per-sequence flip and windowing, in a worker thread
            so sequence i+1's numpy work overlaps sequence i's device work."""
            kl, kr = self.kps_left, self.kps_right
            for item in generator.next_epoch():
                cam, batch_3d, batch_2d = item[:3]
                seq_2d = np.asarray(batch_2d[0], dtype=np.float32)
                if batch_3d is None:
                    seq_3d = np.zeros(seq_2d.shape[:2] + (3,), np.float32)
                else:
                    seq_3d = np.asarray(batch_3d[0], dtype=np.float32)
                cam_vec = np.asarray(cam[0], dtype=np.float32)
                # keypoint-symmetry flip of the conditioning (main.py:645-648)
                seq_2d_flip = seq_2d.copy()
                seq_2d_flip[..., 0] *= -1
                seq_2d_flip[:, kl + kr] = seq_2d_flip[:, kr + kl]
                w2d = window_sequence(seq_2d, rf)
                w2d_f = window_sequence(seq_2d_flip, rf)
                w3d = window_sequence(seq_3d, rf)
                traj = w3d[:, :, :1].copy()
                w3d = w3d.copy()
                w3d[:, :, 0] = 0.0  # root-zero target (main.py:679-680)
                yield cam_vec, w2d, w2d_f, w3d, traj

        dispatched = 0
        for cam_vec, w2d, w2d_f, w3d, traj in Prefetcher(prep(), depth=2):
            W = w2d.shape[0]
            n_batches = (W + bs - 1) // bs
            pred_parts = []
            for b in range(n_batches):
                lo, hi = b * bs, min((b + 1) * bs, W)
                n = hi - lo
                pad = bs - n

                def take(a):
                    x = a[lo:hi]
                    if pad:
                        x = np.concatenate([x, np.repeat(x[:1], pad, 0)], 0)
                    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

                weights = torch.from_numpy(
                    np.concatenate([np.ones(n), np.zeros(pad)]).astype(np.float32)).to(dev)
                cams = torch.from_numpy(np.tile(cam_vec, (bs, 1))).to(dev)
                x2d = take(w2d)
                noise = None
                if noise_provider is not None:
                    noise = provider_noise(noise_provider, n, pad, bs)
                preds = self.d3dp.sample(x2d, take(w2d_f), generator=rng,
                                         noise_override=noise)
                if return_predictions:
                    pred_parts.append(preds[:n])
                    continue
                errors, errors_p2, preds = self._score(preds, x2d, take(w3d), take(traj),
                                                       cams, weights)
                if self.p2 and not self.p2_device:
                    errors_p2 = self._p2_host(preds[:n].cpu().numpy(), w3d[lo:hi],
                                              w2d[lo:hi], cam_vec, traj[lo:hi])
                result.add(errors, errors_p2, weight=n * rf)
                # backpressure: one sync every 16 micro-batches keeps the host
                # from queueing unbounded device work
                dispatched += 1
                if dispatched % 16 == 0:
                    float(errors["P_Best"].sum())
                if self.quickdebug:
                    return result
            if return_predictions:
                preds = torch.cat(pred_parts)
                preds[..., 0, :] = 0.0  # zero root (main.py:700)
                return preds.cpu().numpy()
        return result

    def _p2_host(self, preds, x3d, x2d, cam_vec, traj):
        """Protocol-2 on host numpy (exact reference parity)."""
        B, K, H, F, J, _ = preds.shape
        pred_abs = preds + traj[:, None, None]
        reproj = project_to_2d(
            torch.from_numpy(np.ascontiguousarray(pred_abs.reshape(B, K * H * F * J, 3))),
            torch.from_numpy(np.tile(cam_vec, (B, 1))),
        ).numpy().reshape(B, K, H, F, J, 2)
        return {
            "J_Best": p_mpjpe_diffusion_all_min_np(preds, x3d),
            "P_Best": p_mpjpe_diffusion_np(preds, x3d),
            "P_Agg": p_mpjpe_diffusion_all_min_np(preds, x3d, mean_pos=True),
            "J_Agg": p_mpjpe_diffusion_reproj_np(preds, x3d, reproj, x2d),
        }

"""Windowed multi-hypothesis evaluation.

Counterpart of d3dp_tpu/eval/evaluator.py (reference: main.py:596-794): per
sequence, flip the 2D inputs by keypoint symmetry, window to the receptive
field, micro-batch the windows (padded to a fixed size with 0/1 weights),
DDIM-sample (B,K,H,F,J,3) hypothesis stacks, and score the four
aggregation modes (J-Best, P-Best, P-Agg, J-Agg/JPMA) per micro-batch into
frame-weighted sums. The P1 metrics stay on the device until read.
Protocol-2 runs on host numpy for bit parity with the reference, or with
`p2_device` on the device beside P1 (metrics/procrustes.py). Under a
data-parallel mesh each rank samples and scores its rows of every
micro-batch, and the error sums are all-reduced without waiting.
"""

import itertools
import math
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

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
from d3dp_tpu_torch.parallel.mesh import batch_rows, gather_rows, rank_noise
from d3dp_tpu_torch.utils import profiling

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


class RankSums:
    """One micro-batch's error vectors summed over the dp group's ranks
    (`group`: the mesh's dp group; the ranks of a tp group hold the same
    rows) by an all-reduce that is started here and not waited for. Calling
    it waits and returns {mode: (K,)}; a (K, H) entry (P-Best's
    per-hypothesis means) becomes its minimum over H, taken after the
    sum."""

    def __init__(self, parts, group=None):
        self.shapes = [(m, tuple(v.shape)) for m, v in parts.items()]
        self.flat = torch.cat([v.reshape(-1).float() for v in parts.values()])
        self.work = dist.all_reduce(self.flat, group=group, async_op=True)

    def __call__(self):
        profiling.count("host_syncs")
        self.work.wait()
        out, off = {}, 0
        for m, shape in self.shapes:
            v = self.flat[off:off + math.prod(shape)].view(shape)
            off += v.numel()
            out[m] = torch.amin(v, dim=1) if v.dim() == 2 else v
        return out


@dataclass
class EvalResult:
    """Frame-weighted sums per aggregation mode; (K,) arrays.

    add() keeps the error vectors as they come (device tensors, possibly
    still being computed, or a RankSums still being reduced) so the host
    never waits per micro-batch. They are converted once, at read time, in
    the original sequential float64 summation order."""

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
        with profiling.span("eval.read", sync=True):
            for errors, weight in pending:
                if callable(errors):
                    errors = errors()
                for m, v in errors.items():
                    if isinstance(v, torch.Tensor):
                        profiling.count("host_syncs")
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
                 kps_right=None, p2=False, light=False, quickdebug=False, p2_device=False,
                 mesh=None):
        """`p2` adds Protocol-2 on host numpy. `p2_device=True` (implies p2)
        computes Protocol-2 on the device beside P1 instead, and defers its
        vectors as it does P1's: no host copy per micro-batch. `light=True`
        computes only P-Best (no JPMA reprojection), the reference's
        end-of-epoch validation metric (main.py:455); it takes no P2.
        `quickdebug=True` (the command line's --debug) stops after the first
        micro-batch.

        `mesh` (parallel/mesh.py): each micro-batch's windows split over its
        ranks (batch_size must divide by dp). Every rank draws the global
        micro-batch's sampling noise from the same generator and keeps its
        rows, scores them as its share of the micro-batch's mean (host P2
        on its own real rows), and the shares are all-reduced; the
        prediction return gathers the windows the same way."""
        if light and (p2 or p2_device):
            raise ValueError("light evaluation computes P-Best only; it takes no p2")
        if mesh is not None and batch_size % mesh.dp:
            raise ValueError(f"batch_size {batch_size} not divisible by dp={mesh.dp}")
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
        self.mesh = mesh
        self._calls = 0  # evaluate calls: the unit of their spans

    def _score(self, preds, x2d, x3d, traj, cam, weights, total=None):
        """All four P1 modes of one micro-batch (P-Best only when light), and
        with p2_device the four P2 modes -> (dict of (K,) tensors, the P2
        dict or None, root-zeroed preds). With `total` (a rank of a mesh:
        the global micro-batch's weight sum, a 0-d tensor on the device, so
        the division is the one-device path's) each mode is the rank's
        share of the micro-batch's mean, P-Best's as (K, H) means."""
        preds = preds.clone()
        preds[..., 0, :] = 0.0  # zero root (main.py:700)
        kw = dict(weights=weights, total=total)
        best = dict(kw, per_hypothesis=total is not None)
        if self.light:
            return {"P_Best": mpjpe_diffusion(preds, x3d, **best)}, None, preds
        B, K, H, F, J, _ = preds.shape
        pred_abs = preds + traj[:, None, None]  # JPMA reprojection (main.py:705-712)
        reproj = project_to_2d(pred_abs.reshape(B, K * H * F * J, 3), cam
                               ).reshape(B, K, H, F, J, 2)
        errors = {
            "J_Best": mpjpe_diffusion_all_min(preds, x3d, **kw),
            "P_Best": mpjpe_diffusion(preds, x3d, **best),
            "P_Agg": mpjpe_diffusion_all_min(preds, x3d, mean_pos=True, **kw),
            "J_Agg": mpjpe_diffusion_reproj(preds, x3d, reproj, x2d, **kw),
        }
        errors_p2 = None
        if self.p2_device:
            errors_p2 = {
                "J_Best": p_mpjpe_diffusion_all_min(preds, x3d, **kw),
                "P_Best": p_mpjpe_diffusion(preds, x3d, **best),
                "P_Agg": p_mpjpe_diffusion_all_min(preds, x3d, mean_pos=True, **kw),
                "J_Agg": p_mpjpe_diffusion_reproj(preds, x3d, reproj, x2d, **kw),
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
        self._calls += 1
        with profiling.span("eval.evaluate", unit=self._calls - 1):
            return self._evaluate(generator, rng, noise_provider, return_predictions)

    def _evaluate(self, generator, rng, noise_provider, return_predictions):
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

        mesh = self.mesh
        rows = slice(None) if mesh is None else batch_rows(bs, mesh)
        units = itertools.count()
        dispatched = 0
        for cam_vec, w2d, w2d_f, w3d, traj in Prefetcher(prep(), depth=2):
            W = w2d.shape[0]
            n_batches = (W + bs - 1) // bs
            pred_parts = []
            for b in range(n_batches):
                with profiling.span("eval.microbatch", unit=next(units)):
                    lo, hi = b * bs, min((b + 1) * bs, W)
                    n = hi - lo
                    pad = bs - n

                    def take(a):
                        x = a[lo:hi]
                        if pad:
                            x = np.concatenate([x, np.repeat(x[:1], pad, 0)], 0)
                        return torch.from_numpy(np.ascontiguousarray(x[rows])).to(dev)

                    # every host-to-device copy of the micro-batch: each
                    # one, from pageable memory, waits for the device
                    with profiling.span("eval.feed", sync=True):
                        w = np.concatenate([np.ones(n), np.zeros(pad)]).astype(np.float32)[rows]
                        weights = torch.from_numpy(w).to(dev)
                        cams = torch.from_numpy(np.tile(cam_vec, (len(w), 1))).to(dev)
                        x2d, x2d_flip = take(w2d), take(w2d_f)
                        if not return_predictions:
                            x3d, traj_b = take(w3d), take(traj)
                        profiling.count("host_syncs", 4 if return_predictions else 6)
                        noise = None
                        if noise_provider is not None:
                            noise = provider_noise(noise_provider, n, pad, bs)
                        if mesh is not None:
                            noise = rank_noise(self.d3dp, bs, rng, mesh, noise)
                    preds = self.d3dp.sample(x2d, x2d_flip, generator=rng, noise_override=noise)
                    if return_predictions:
                        pred_parts.append(preds if mesh is not None else preds[:n])
                        continue
                    with profiling.span("eval.score", device=dev):
                        errors, errors_p2, preds = self._score(
                            preds, x2d, x3d, traj_b, cams, weights,
                            total=None if mesh is None else torch.full((), float(n), device=dev))
                    if self.p2 and not self.p2_device:
                        with profiling.span("eval.p2_host", sync=True):
                            if mesh is None:
                                profiling.count("host_syncs")
                                errors_p2 = self._p2_host(preds[:n].cpu().numpy(), w3d[lo:hi],
                                                          w2d[lo:hi], cam_vec, traj[lo:hi])
                            else:
                                errors_p2 = self._p2_host_share(preds, n, lo, rows, w3d, w2d,
                                                                cam_vec, traj)
                    local = errors
                    if mesh is not None:
                        errors = RankSums(errors, mesh.dp_group)
                        errors_p2 = (None if errors_p2 is None
                                     else RankSums(errors_p2, mesh.dp_group))
                    result.add(errors, errors_p2, weight=n * rf)
                    # backpressure: one sync every 16 micro-batches keeps the
                    # host from queueing unbounded device work
                    dispatched += 1
                    if dispatched % 16 == 0:
                        with profiling.span("eval.drain", sync=True):
                            profiling.count("host_syncs")
                            float(local["P_Best"].sum())
                    if self.quickdebug:
                        return result
            if return_predictions:
                preds = (torch.cat(pred_parts) if mesh is None
                         else gather_rows(pred_parts, bs, mesh)[:W])
                preds[..., 0, :] = 0.0  # zero root (main.py:700)
                profiling.count("host_syncs")
                return preds.cpu().numpy()
        return result

    def _p2_host_share(self, preds, n, lo, rows, w3d, w2d, cam_vec, traj):
        """A rank's share of host P2 on a micro-batch of n real windows from
        window `lo`: the means over its real rows, weighted by their share
        of the n, as device tensors for the all-reduce (P-Best per
        hypothesis)."""
        r_lo, r_hi = rows.start, min(rows.stop, n)
        B, K, H = preds.shape[:3]
        if r_hi <= r_lo:
            zeros = torch.zeros(K, device=preds.device)
            return {"J_Best": zeros, "P_Best": torch.zeros(K, H, device=preds.device),
                    "P_Agg": zeros, "J_Agg": zeros}
        g = slice(lo + r_lo, lo + r_hi)
        profiling.count("host_syncs", 5)  # the read of the rows and the four uploads
        e = self._p2_host(preds[:r_hi - r_lo].cpu().numpy(), w3d[g], w2d[g], cam_vec, traj[g],
                          per_hypothesis=True)
        share = (r_hi - r_lo) / n
        return {m: torch.from_numpy(np.asarray(v * share, np.float32)).to(preds.device)
                for m, v in e.items()}

    def _p2_host(self, preds, x3d, x2d, cam_vec, traj, per_hypothesis=False):
        """Protocol-2 on host numpy (exact reference parity); P-Best's
        `per_hypothesis` as in metrics.mpjpe.mpjpe_diffusion."""
        B, K, H, F, J, _ = preds.shape
        pred_abs = preds + traj[:, None, None]
        reproj = project_to_2d(
            torch.from_numpy(np.ascontiguousarray(pred_abs.reshape(B, K * H * F * J, 3))),
            torch.from_numpy(np.tile(cam_vec, (B, 1))),
        ).numpy().reshape(B, K, H, F, J, 2)
        return {
            "J_Best": p_mpjpe_diffusion_all_min_np(preds, x3d),
            "P_Best": p_mpjpe_diffusion_np(preds, x3d, per_hypothesis=per_hypothesis),
            "P_Agg": p_mpjpe_diffusion_all_min_np(preds, x3d, mean_pos=True),
            "J_Agg": p_mpjpe_diffusion_reproj_np(preds, x3d, reproj, x2d),
        }

"""MPI-INF-3DHP evaluation: valid-frame-masked metrics and the pose
selections exported for the PCK/AUC harness.

Counterpart of d3dp_tpu/eval/evaluator_3dhp.py (reference: main_3dhp.py
evaluate(), :659-912): per test sequence TS1..TS6, flip the 2D inputs by
keypoint symmetry, window 2D, 3D and the valid mask to the receptive field,
micro-batch the windows (padded to a fixed size with zero-weight windows
whose valid masks are zero), DDIM-sample, score the masked P-Best and P-Agg,
select poses per aggregation mode (P-Agg mean, P-Best one hypothesis per
step, J-Best oracle, J-Agg by pixel-space reprojection with the sequence's
intrinsics), stitch the windows back and export inference_data_<mode>.mat.

The error vectors and selections stay on the device until the loop ends:
the host neither waits per micro-batch nor per sequence. Sequence i+1's
windowing runs in a worker thread while the device samples sequence i.
Under a data-parallel mesh each rank samples and scores its rows of every
micro-batch: the error shares are all-reduced without waiting, P-Best's
selection statistic is all-reduced before its choice, the selections
are gathered per sequence, and only rank 0 stitches and writes the exports.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from d3dp_tpu_torch.data.mpi3dhp import (
    KPS_LEFT,
    KPS_RIGHT,
    ROOT_JOINT,
    camera_for_sequence,
    uses_distortion_projection,
)
from d3dp_tpu_torch.data.prefetch import Prefetcher
from d3dp_tpu_torch.data.windowing import stitch_windows, window_sequence
from d3dp_tpu_torch.eval.aggregation import (
    select_j_agg,
    select_j_best,
    select_p_agg,
    select_p_best,
)
from d3dp_tpu_torch.eval.evaluator import RankSums, provider_noise
from d3dp_tpu_torch.geometry.camera import image_coordinates, project_to_2d, project_to_2d_linear
from d3dp_tpu_torch.metrics.mpjpe import mpjpe_diffusion, mpjpe_diffusion_3dhp
from d3dp_tpu_torch.parallel.mesh import batch_rows, gather_rows, rank_noise

MODES = ("P_Agg", "P_Best", "J_Best", "J_Agg")


class Evaluator3DHP:
    def __init__(self, d3dp, receptive_field=243, batch_size=2, quickdebug=False, mesh=None):
        """`quickdebug=True` (the command line's --debug) stops after the
        first micro-batch. `mesh` (parallel/mesh.py): each micro-batch's
        windows split over its ranks (batch_size must divide by dp), as in
        Evaluator."""
        if mesh is not None and batch_size % mesh.dp:
            raise ValueError(f"batch_size {batch_size} not divisible by dp={mesh.dp}")
        self.mesh = mesh
        self.d3dp = d3dp
        self.device = d3dp.device
        self.rf = receptive_field
        self.bs = batch_size
        self.quickdebug = quickdebug

    def _score(self, preds, x2d, x3d, traj, valid, win_weights, cam, distortion, width, height,
               totals=None):
        """One micro-batch's masked (K,) P-Best / P-Agg errors and its four
        selected pose stacks (B, K, F, J, 3). x3d: root(14)-zeroed target in
        mm; traj (B, F, 1, 3); valid (B, F) 0/1, zero on padded windows; cam
        (9,) pixel intrinsics. (main_3dhp.py:772-860) With `totals` (a rank
        of a mesh: the global micro-batch's (valid-frame count, window
        count), 0-d tensors on the device) the errors are the rank's shares,
        P-Best's as (K, H) means, and P-Best's selection statistic is summed
        over the ranks first."""
        preds = preds.clone()
        preds[..., ROOT_JOINT, :] = 0.0
        B, K, H, F, J, _ = preds.shape
        frames, windows = (None, None) if totals is None else totals
        errors = {
            "P_Best": mpjpe_diffusion_3dhp(preds, x3d, valid, total=frames,
                                           per_hypothesis=totals is not None),
            "P_Agg": mpjpe_diffusion_3dhp(preds, x3d, valid, mean_pos=True, total=frames),
        }
        per_kh = None
        if totals is not None:
            per_kh = mpjpe_diffusion(preds, x3d, weights=win_weights, total=windows,
                                     per_hypothesis=True)
            dist.all_reduce(per_kh, group=self.mesh.dp_group)
        # JPMA in pixel space with the sequence's camera (main_3dhp.py:806-835)
        pred_abs = preds + traj[:, None, None]
        proj = project_to_2d if distortion else project_to_2d_linear
        reproj = proj(pred_abs.reshape(B, K * H * F * J, 3), cam.expand(B, 9)
                      ).reshape(B, K, H, F, J, 2)
        target_2d = image_coordinates(x2d[..., :2], w=width, h=height)
        selections = {
            "P_Agg": select_p_agg(preds),
            "P_Best": select_p_best(preds, x3d, weights=win_weights, per_kh=per_kh),
            "J_Best": select_j_best(preds, x3d),
            "J_Agg": select_j_agg(preds, reproj, target_2d),
        }
        return errors, selections

    def evaluate(self, generator, rng=None, export_dir=None, noise_provider=None):
        """Run the loop over an UnchunkedGenerator built with valid_frames
        and keys.

        `rng`: torch.Generator on the sampler's device, drawn from in order
        across micro-batches. `noise_provider(n)` (optional) replaces the
        sampler's draws per micro-batch, as in Evaluator.evaluate.

        Returns ({"P_Best", "P_Agg"}: (K,) frame-weighted masked errors in
        mm, {mode: {TS key: (3, J, Ftot, K)}} exports), and writes the four
        inference_data_<mode>.mat files when `export_dir` is given
        (main_3dhp.py:903-912). Under a mesh every rank returns the errors,
        and only rank 0 the exports (the others' are empty) and the files.
        """
        rf, bs, dev = self.rf, self.bs, self.device

        def prep():
            """Host-side per-sequence flip and windowing, in a worker thread."""
            for _, batch_3d, batch_2d, valid_seq, seq_key in generator.next_epoch():
                seq_2d = np.asarray(batch_2d[0], np.float32)
                seq_3d = np.asarray(batch_3d[0], np.float32)
                valid_seq = np.asarray(valid_seq, np.float32).ravel()
                seq_2d_flip = seq_2d.copy()
                seq_2d_flip[..., 0] *= -1
                seq_2d_flip[:, KPS_LEFT + KPS_RIGHT] = seq_2d_flip[:, KPS_RIGHT + KPS_LEFT]
                w3d = window_sequence(seq_3d, rf)
                traj = w3d[:, :, ROOT_JOINT : ROOT_JOINT + 1].copy()
                w3d = w3d.copy()
                w3d[:, :, ROOT_JOINT] = 0.0
                yield (seq_key, seq_2d.shape[0], window_sequence(seq_2d, rf),
                       window_sequence(seq_2d_flip, rf), w3d, traj,
                       window_sequence(valid_seq, rf))

        mesh = self.mesh
        rows = slice(None) if mesh is None else batch_rows(bs, mesh)
        pending = []  # ((K,) error dict on the device, or a RankSums; frame weight)
        sequences = []  # (key, Ftot, W, {mode: [device selections]} or (gathered, work))
        dispatched = 0
        for seq_key, Ftot, w2d, w2d_f, w3d, traj, wv in Prefetcher(prep(), depth=2):
            cam, (width, height) = camera_for_sequence(seq_key)
            cam = torch.from_numpy(cam).to(dev)
            distortion = uses_distortion_projection(seq_key)
            W = w2d.shape[0]
            sel_parts = {m: [] for m in MODES}
            for b in range((W + bs - 1) // bs):
                lo, hi = b * bs, min((b + 1) * bs, W)
                n, pad = hi - lo, bs - (hi - lo)

                def pad_rows(a, fill=None):
                    x = a[lo:hi]
                    if pad:
                        rows_ = (np.repeat(x[:1], pad, 0) if fill is None
                                 else np.full((pad,) + x.shape[1:], fill, x.dtype))
                        x = np.concatenate([x, rows_], 0)
                    return x

                def take(a, fill=None):
                    x = pad_rows(a, fill)[rows]
                    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

                win_w = take(np.ones(W, np.float32), fill=0.0)
                x2d = take(w2d)
                noise = None
                if noise_provider is not None:
                    noise = provider_noise(noise_provider, n, pad, bs)
                if mesh is not None:
                    noise = rank_noise(self.d3dp, bs, rng, mesh, noise)
                preds = self.d3dp.sample(x2d, take(w2d_f), generator=rng, noise_override=noise)
                totals = None if mesh is None else tuple(
                    torch.full((), v, device=dev) for v in (float(pad_rows(wv, fill=0.0).sum()),
                                                            float(n)))
                errors, selections = self._score(
                    preds, x2d, take(w3d), take(traj), take(wv, fill=0.0), win_w, cam,
                    distortion, width, height, totals=totals)
                local = errors
                pending.append((errors if mesh is None else RankSums(errors, mesh.dp_group),
                                n * rf))
                for m in MODES:
                    sel_parts[m].append(selections[m] if mesh is not None else selections[m][:n])
                # backpressure: one sync every 16 micro-batches keeps the host
                # from queueing unbounded device work
                dispatched += 1
                if dispatched % 16 == 0:
                    float(local["P_Best"].sum())
                if self.quickdebug:
                    break
            if mesh is not None:  # every mode's selections of the sequence, one all-reduce
                parts = [torch.stack([sel_parts[m][i] for m in MODES])
                         for i in range(len(sel_parts[MODES[0]]))]
                gathered, work = gather_rows([p.transpose(0, 1) for p in parts], bs, mesh,
                                             async_op=True)
                sel_parts = (gathered, work)
            sequences.append((seq_key, Ftot, W, sel_parts))
            if self.quickdebug:
                break

        # the original's sequential float64 sums over micro-batches
        sums = {"P_Best": 0.0, "P_Agg": 0.0}
        N = 0
        for errors, weight in pending:
            if callable(errors):
                errors = errors()
            for m in sums:
                sums[m] = sums[m] + errors[m].double().cpu().numpy() * weight
            N += weight
        results = {m: sums[m] / max(N, 1) for m in sums}

        exports = {m: {} for m in MODES}
        for seq_key, Ftot, W, sel_parts in sequences:
            if mesh is not None:
                gathered, work = sel_parts
                work.wait()
                if mesh.rank != 0:  # rank 0 stitches and writes the exports
                    continue
                sel_parts = {m: [gathered[:, i]] for i, m in enumerate(MODES)}
            for m in MODES:
                sel = torch.cat(sel_parts[m]).cpu().numpy()  # (W', K, F, J, 3)
                if sel.shape[0] < W:  # quickdebug: the sequence is not covered
                    continue
                sel = sel[:W]
                # stitch per DDIM step, then the (3, J, Ftot, K) .mat layout
                stitched = np.stack([stitch_windows(sel[:, k], Ftot)
                                     for k in range(sel.shape[1])])
                exports[m][seq_key] = stitched.transpose(3, 2, 1, 0)

        if export_dir is not None and (mesh is None or mesh.rank == 0):
            import scipy.io as scio

            os.makedirs(export_dir, exist_ok=True)
            for m in MODES:
                scio.savemat(os.path.join(export_dir, f"inference_data_{m}.mat"), exports[m])
        return results, exports

"""The four Protocol-1 aggregation modes of D3DP's evaluation (common/
loss.py and main.py's evaluate), and the Human3.6M camera projection that
J-Agg selects by, in plain PyTorch.

preds (B, K, H, F, J, 3) root-zeroed, target (B, F, J, 3) root-zeroed,
each mode a (K,) vector of the mean over the real windows, in the
dataset's units:
  P-Best  the best hypothesis by its mean error,
  J-Best  the best hypothesis joint by joint,
  P-Agg   the mean of the hypotheses,
  J-Agg   (JPMA) joint by joint, the hypothesis whose reprojection lies
          nearest the 2D input.
"""

import torch


def project_to_2d(X, cam):
    """Camera-space points X (N, ..., 3) to 2D with the (N, 9) intrinsics:
    focal (2), centre (2), radial k1-k3 (3), tangential p1-p2 (2)."""
    while cam.dim() < X.dim():
        cam = cam.unsqueeze(1)
    f, c, k, p = cam[..., :2], cam[..., 2:4], cam[..., 4:7], cam[..., 7:]
    xx = torch.clamp(X[..., :2] / X[..., 2:], -1.0, 1.0)
    r2 = torch.sum(xx ** 2, dim=-1, keepdim=True)
    radial = 1 + torch.sum(k * torch.cat((r2, r2 ** 2, r2 ** 3), dim=-1), dim=-1, keepdim=True)
    tan = torch.sum(p * xx, dim=-1, keepdim=True)
    return f * (xx * (radial + tan) + p * r2) + c


def four_modes(preds, target, traj, x2d, cam):
    """{mode: (K,)} of the windows given (every one real).

    traj: (B, F, 1, 3) the root's camera-space position, added back before
    the reprojection; x2d: (B, F, J, 2) the 2D input; cam: (B, 9)."""
    err = torch.linalg.vector_norm(preds - target[:, None, None], dim=-1)  # (B,K,H,F,J)
    B, K, H, Fr, J = err.shape
    p_best = err.mean(dim=(0, 3, 4)).amin(dim=1)
    j_best = err.amin(dim=2).mean(dim=(0, 2, 3))
    p_agg = torch.linalg.vector_norm(preds.mean(dim=2) - target[:, None], dim=-1).mean(
        dim=(0, 2, 3))
    absolute = preds + traj[:, None, None]
    reproj = project_to_2d(absolute.reshape(B, -1, 3), cam).reshape(B, K, H, Fr, J, 2)
    err2d = torch.linalg.vector_norm(reproj - x2d[:, None, None], dim=-1)
    pick = err2d.argmin(dim=2, keepdim=True)  # ties to the lowest hypothesis
    j_agg = torch.gather(err, 2, pick).squeeze(2).mean(dim=(0, 2, 3))
    return {"J_Best": j_best, "P_Best": p_best, "P_Agg": p_agg, "J_Agg": j_agg}

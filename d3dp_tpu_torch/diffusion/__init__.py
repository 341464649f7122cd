from d3dp_tpu_torch.diffusion.d3dp import D3DP, D3DPConfig, flip_pose, make_lr_perm
from d3dp_tpu_torch.diffusion.schedule import CosineSchedule, cosine_beta_schedule, ddim_time_pairs

__all__ = ["D3DP", "D3DPConfig", "flip_pose", "make_lr_perm", "CosineSchedule",
           "cosine_beta_schedule", "ddim_time_pairs"]

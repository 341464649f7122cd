from d3dp_tpu_torch.metrics.mpjpe import (
    joint_select_by_reproj,
    mean_velocity_error,
    mean_velocity_error_train,
    mpjpe,
    mpjpe_diffusion,
    mpjpe_diffusion_3dhp,
    mpjpe_diffusion_all_min,
    mpjpe_diffusion_reproj,
    n_mpjpe,
)
from d3dp_tpu_torch.metrics.procrustes import (
    p_mpjpe,
    p_mpjpe_diffusion,
    p_mpjpe_diffusion_all_min,
    p_mpjpe_diffusion_reproj,
    procrustes_align,
)
from d3dp_tpu_torch.metrics.procrustes_np import (
    p_mpjpe_diffusion_all_min_np,
    p_mpjpe_diffusion_np,
    p_mpjpe_diffusion_reproj_np,
    p_mpjpe_np,
    procrustes_align_np,
)

__all__ = [
    "joint_select_by_reproj", "mean_velocity_error", "mean_velocity_error_train", "mpjpe",
    "mpjpe_diffusion", "mpjpe_diffusion_3dhp", "mpjpe_diffusion_all_min",
    "mpjpe_diffusion_reproj", "n_mpjpe",
    "p_mpjpe", "p_mpjpe_diffusion", "p_mpjpe_diffusion_all_min", "p_mpjpe_diffusion_reproj",
    "procrustes_align",
    "p_mpjpe_diffusion_all_min_np", "p_mpjpe_diffusion_np",
    "p_mpjpe_diffusion_reproj_np", "p_mpjpe_np", "procrustes_align_np",
]

from d3dp_tpu_torch.metrics.mpjpe import (
    joint_select_by_reproj,
    mpjpe,
    mpjpe_diffusion,
    mpjpe_diffusion_all_min,
    mpjpe_diffusion_reproj,
)
from d3dp_tpu_torch.metrics.procrustes_np import (
    p_mpjpe_diffusion_all_min_np,
    p_mpjpe_diffusion_np,
    p_mpjpe_diffusion_reproj_np,
    p_mpjpe_np,
    procrustes_align_np,
)

__all__ = [
    "joint_select_by_reproj", "mpjpe", "mpjpe_diffusion",
    "mpjpe_diffusion_all_min", "mpjpe_diffusion_reproj",
    "p_mpjpe_diffusion_all_min_np", "p_mpjpe_diffusion_np",
    "p_mpjpe_diffusion_reproj_np", "p_mpjpe_np", "procrustes_align_np",
]

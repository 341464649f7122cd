"""Device-generation awareness for the kernels' baked tile choices.

Counterpart of d3dp_tpu/ops/tuning.py. The kernels' tile sizes and
schedules are measured choices from one card, the NVIDIA H100 80GB HBM3
(PERF.md): the 64- and 128-row wgmma tiles of the stage and MLP walks
(`csrc/stage.cuh`, `csrc/mlp.cuh`), the weight rings' depths, the
attention tile's 64-key groups, and the depth-resident kernel's
`group_rows` (`ops/resident.py`). They are correct on any card that runs
`sm_90a` code, but untuned elsewhere (an H200, a card with a lower power
limit behaves differently; a card without sm_90a does not run them at
all). So the first kernel launch on another card emits one advisory, as
the JAX package's first kernel launch does off the TPU generation it was
tuned on. The port has no tile overrides to suppress it with.
"""

import warnings

TUNED_DEVICE = "NVIDIA H100 80GB HBM3"

_checked = False


def check_tile_generation(device_name=None):
    """One advisory a process when the card (`torch.cuda.get_device_name()`,
    or `device_name`) is not the one the tile sizes were measured on;
    called by the first kernel launch (`ops._build.load`)."""
    global _checked
    if _checked:
        return
    _checked = True
    if device_name is None:
        import torch

        device_name = torch.cuda.get_device_name()
    if device_name == TUNED_DEVICE:
        return
    warnings.warn(
        f"d3dp_tpu_torch kernel tile sizes were measured on the {TUNED_DEVICE}; this card "
        f"is {device_name!r}. They are correct on any sm_90a card but may be slow here: "
        "time them with `python -m d3dp_tpu_torch.utils.time_attention` and chip_smoke.py "
        "before relying on them.", stacklevel=3)

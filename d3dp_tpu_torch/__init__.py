"""d3dp_tpu_torch: the PyTorch/CUDA port of d3dp_tpu for NVIDIA Hopper.

The module layout mirrors `d3dp_tpu`. Plain tensor code is PyTorch; the
kernels the JAX package wrote in Pallas are hand-written CUDA under
`ops/csrc/`, built at first use. This package never imports JAX or
`d3dp_tpu`.
"""

from d3dp_tpu_torch.device import disable_tf32, resolve_device

__all__ = ["disable_tf32", "resolve_device"]

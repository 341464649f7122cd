"""Device selection and the fp32 precision rule.

Entry points run on the card unless the caller asks for the CPU: with no
`device` they take `cuda`, and without a card they raise rather than fall
back to the CPU.
"""

import torch


def resolve_device(device=None):
    """`device` as a torch.device; None means the card. Raises if the card
    is asked for (explicitly or by default) and torch sees none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "d3dp_tpu_torch runs on a CUDA device and torch sees none; pass "
            "device='cpu' to run the plain-torch path on the CPU")
    return dev


def disable_tf32():
    """fp32 products in full fp32: the torch form of the JAX package's
    `precision="highest"` rule. cuDNN would otherwise run fp32 in TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

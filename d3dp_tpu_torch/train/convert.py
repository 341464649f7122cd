"""Weight bridges for MixSTE2.

`state_dict_from_flax` is the exact inverse of the JAX package's
`torch_mixste_to_flax` (d3dp_tpu/train/convert_torch.py): it maps the JAX
params tree (as numpy arrays) to the original PyTorch state_dict names,
transposing Dense kernels (in, out) back to Linear weights (out, in).
`load_reference_checkpoint` reads an original `.bin` checkpoint.
"""

import numpy as np
import torch


def _lin(name, p):
    return {f"{name}.weight": np.asarray(p["kernel"]).T,
            f"{name}.bias": np.asarray(p["bias"])}


def _ln(name, p):
    return {f"{name}.weight": np.asarray(p["scale"]),
            f"{name}.bias": np.asarray(p["bias"])}


def state_dict_from_flax(params_np, depth):
    """JAX MixSTE2 params tree (the 'params' subtree, numpy leaves) ->
    {original state_dict key: torch tensor}."""
    p = params_np
    sd = {}
    sd.update(_lin("Spatial_patch_to_embedding", p["joint_embed"]))
    sd["Spatial_pos_embed"] = np.asarray(p["spatial_pos_embed"])
    sd["Temporal_pos_embed"] = np.asarray(p["temporal_pos_embed"])
    sd.update(_lin("time_mlp.1", p["time_mlp_fc1"]))
    sd.update(_lin("time_mlp.3", p["time_mlp_fc2"]))
    for kind, prefix in (("ste", "STEblocks"), ("tte", "TTEblocks")):
        for i in range(depth):
            b, pre = p[f"{kind}_{i}"], f"{prefix}.{i}"
            sd.update(_ln(f"{pre}.norm1", b["norm1"]))
            sd.update(_lin(f"{pre}.attn.qkv", b["attn"]["qkv"]))
            sd.update(_lin(f"{pre}.attn.proj", b["attn"]["proj"]))
            sd.update(_ln(f"{pre}.norm2", b["norm2"]))
            sd.update(_lin(f"{pre}.mlp.fc1", b["mlp"]["fc1"]))
            sd.update(_lin(f"{pre}.mlp.fc2", b["mlp"]["fc2"]))
    sd.update(_ln("Spatial_norm", p["spatial_norm"]))
    sd.update(_ln("Temporal_norm", p["temporal_norm"]))
    sd.update(_ln("head.0", p["head_norm"]))
    sd.update(_lin("head.1", p["head"]))
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def strip_prefixes(state_dict):
    """Drop the DataParallel 'module.' prefix; where the diffusion wrapper's
    'pose_estimator.' entries are present keep only those (the wrapper's own
    schedule buffers are not MixSTE2's), without the prefix."""
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in state_dict.items()}
    pe = "pose_estimator."
    if any(k.startswith(pe) for k in sd):
        sd = {k[len(pe):]: v for k, v in sd.items() if k.startswith(pe)}
    return sd


def load_reference_checkpoint(path):
    """Original `.bin` checkpoint -> (MixSTE2 state_dict, metadata).
    (counterpart of d3dp_tpu/train/convert_torch.py:136)"""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = strip_prefixes(ckpt["model_pos"])
    meta = {k: ckpt.get(k) for k in ("epoch", "lr") if k in ckpt}
    return sd, meta

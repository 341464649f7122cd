"""MixSTE2, D3DP's denoiser (arXiv:2303.11579): what the harness takes
from the architecture (port_bench/arch/__init__.py). The configuration's
`model` holds the keys of the port's `MixSTEConfig`."""

import torch

from port_bench.reference.model import MixSTE2, build, droppath_rates


def parameter_shapes(model_cfg):
    """[(state_dict key, shape, kind)], learnt from the reference's module
    built on the meta device."""
    with torch.device("meta"):
        m = MixSTE2(model_cfg["num_frames"], model_cfg["num_joints"], model_cfg["embed_dim"],
                    model_cfg["depth"], model_cfg["num_heads"], model_cfg["mlp_ratio"],
                    model_cfg.get("in_chans", 2))
    linear, norm = set(), set()
    for name, mod in m.named_modules():
        if isinstance(mod, torch.nn.Linear):
            linear.add(f"{name}.weight")
        elif isinstance(mod, torch.nn.LayerNorm):
            norm.add(f"{name}.weight")
    return [(k, tuple(v.shape), "linear" if k in linear else "norm" if k in norm else "other")
            for k, v in m.state_dict().items()]


reference = build


def denoiser_config(m):
    """The port's MixSTEConfig of the configuration's `model`."""
    from d3dp_tpu_torch.models import MixSTEConfig

    return MixSTEConfig(num_frames=m["num_frames"], num_joints=m["num_joints"],
                        in_chans=m["in_chans"], embed_dim=m["embed_dim"], depth=m["depth"],
                        num_heads=m["num_heads"], mlp_ratio=m["mlp_ratio"],
                        drop_path_rate=m["drop_path_rate"],
                        dtype=getattr(torch, m["dtype"]), fuse_level=m["fuse_level"])


def step_draws(state, device, B, model_cfg, timesteps):
    """(t, noise, masks) of one step from a generator at `state`: t (B,)
    and the noise (B, F, J, 3), then for each depth i and each of the
    spatial and the temporal block whose DropPath rate is above 0, two
    uniform vectors of one value a row (B*F spatial rows, B*J temporal),
    each a mask of 1/keep where u < keep and 0 elsewhere."""
    g = torch.Generator(device=device)
    g.set_state(state)
    Fr, J = model_cfg["num_frames"], model_cfg["num_joints"]
    t = torch.randint(0, timesteps, (B,), generator=g, device=device)
    noise = torch.randn((B, Fr, J, 3), generator=g, device=device)
    masks = {}
    for i, rate in enumerate(droppath_rates(model_cfg)):
        rate = float(rate)
        for kind, per in (("ste", Fr), ("tte", J)):
            if rate <= 0.0:
                continue
            keep = 1.0 - rate
            masks[f"{kind}_{i}"] = tuple(
                torch.where(torch.rand(B * per, generator=g, device=device) < keep,
                            1.0 / keep, 0.0) for _ in range(2))
    return t, noise, masks


def forward_flops(m):
    """Operations of one MixSTE2 forward on one (F, J) row: the joint
    embedding, the time MLP, 2*depth blocks (qkv 6C^2, projection 2C^2,
    MLP 4*C*Hd a token, attention 4*N*C a token over N = J spatially and
    N = F temporally) and the head."""
    C, Fr, J, depth = m["embed_dim"], m["num_frames"], m["num_joints"], m["depth"]
    hidden = int(C * m["mlp_ratio"])
    tokens = Fr * J
    per_token = 8 * C * C + 4 * C * hidden
    blocks = depth * tokens * (2 * per_token + 4 * J * C + 4 * Fr * C)
    return 2 * tokens * (m["in_chans"] + 3) * C + 8 * C * C + blocks + 2 * tokens * C * 3


def blocks(m):
    """(spatial, temporal) blocks a forward: one STE and one TTE block a
    depth."""
    return m["depth"], m["depth"]

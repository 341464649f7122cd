"""MixSTE2, the D3DP denoiser, in plain PyTorch under the original
state_dict keys (D3DP's common/mixste.py; arXiv:2303.11579).

A straightforward statement of the network for the benchmark's
comparison: every layer in the dtype of the parameters (float64 for the
yardstick), attention as softmax(q k^T * scale) v, exact-erf GELU, LayerNorm
eps 1e-6 in the blocks and the shared norms and 1e-5 in the head, one shared
spatial and one shared temporal norm after every block, the temporal
position embedding added once, after the first spatial block. DropPath
takes its per-row scales from the caller (`masks`). `mm` replaces every
matrix product (the controls' lower precisions, `precision.matmul_fn`).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

BLOCK_EPS = 1e-6
HEAD_EPS = 1e-5


def time_embedding(t, dim, dtype):
    """Sinusoidal embedding of the diffusion step t (B,) -> (B, dim)."""
    half = dim // 2
    freq = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=dtype, device=t.device) * -freq)
    args = t.to(dtype)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class Attention(nn.Module):
    def __init__(self, dim, heads):
        super().__init__()
        self.heads = heads
        self.scale = (dim // heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Block(nn.Module):
    def __init__(self, dim, hidden, heads):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.mlp = Mlp(dim, hidden)


class MixSTE2(nn.Module):
    """forward(x2d (B,F,J,2), x3d (B,F,J,3), t (B,)) -> (B,F,J,3)."""

    def __init__(self, num_frames, num_joints, embed_dim, depth, num_heads, mlp_ratio,
                 in_chans=2):
        super().__init__()
        C = embed_dim
        self.depth = depth
        self.Spatial_patch_to_embedding = nn.Linear(in_chans + 3, C)
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, num_joints, C))
        self.Temporal_pos_embed = nn.Parameter(torch.zeros(1, num_frames, C))
        self.time_mlp = nn.Sequential(nn.Identity(), nn.Linear(C, 2 * C), nn.GELU(),
                                      nn.Linear(2 * C, C))
        hidden = int(C * mlp_ratio)
        self.STEblocks = nn.ModuleList(Block(C, hidden, num_heads) for _ in range(depth))
        self.TTEblocks = nn.ModuleList(Block(C, hidden, num_heads) for _ in range(depth))
        self.Spatial_norm = nn.LayerNorm(C, eps=BLOCK_EPS)
        self.Temporal_norm = nn.LayerNorm(C, eps=BLOCK_EPS)
        self.head = nn.Sequential(nn.LayerNorm(C, eps=HEAD_EPS), nn.Linear(C, 3))

    @staticmethod
    def _linear(mm, lin, x):
        return mm(x, lin.weight.transpose(0, 1)).to(x.dtype) + lin.bias

    def _attention(self, mm, attn, x):
        R, N, C = x.shape
        h = attn.heads
        qkv = self._linear(mm, attn.qkv, x).view(R, N, 3, h, C // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        s = mm(q, k.transpose(-1, -2)).to(x.dtype) * attn.scale
        o = mm(torch.softmax(s, dim=-1), v).to(x.dtype)
        return self._linear(mm, attn.proj, o.transpose(1, 2).reshape(R, N, C))

    def _block(self, mm, blk, x, masks):
        a = self._attention(mm, blk.attn, blk.norm1(x))
        if masks is not None:
            a = a * masks[0].to(x.dtype)[:, None, None]
        x = x + a
        hdn = F.gelu(self._linear(mm, blk.mlp.fc1, blk.norm2(x)), approximate="none")
        m = self._linear(mm, blk.mlp.fc2, hdn)
        if masks is not None:
            m = m * masks[1].to(x.dtype)[:, None, None]
        return x + m

    def forward(self, x2d, x3d, t, masks=None, mm=torch.matmul):
        """masks: None or {"ste_i" / "tte_i": (attention scale, MLP scale)},
        each (rows,), for the blocks that drop paths; spatial rows are
        B*F (b-major), temporal rows B*J."""
        dt = self.Spatial_pos_embed.dtype
        B, Fr, J, _ = x3d.shape
        C = self.Spatial_pos_embed.shape[-1]
        masks = masks or {}
        x = self._linear(mm, self.Spatial_patch_to_embedding,
                         torch.cat([x2d, x3d], dim=-1).to(dt))
        temb = time_embedding(t, C, dt)
        temb = self._linear(mm, self.time_mlp[3],
                            F.gelu(self._linear(mm, self.time_mlp[1], temb), approximate="none"))
        x = x + self.Spatial_pos_embed + temb[:, None, None, :]
        h = x.reshape(B * Fr, J, C)
        for i in range(self.depth):
            h = self.Spatial_norm(self._block(mm, self.STEblocks[i], h, masks.get(f"ste_{i}")))
            h = h.view(B, Fr, J, C).transpose(1, 2).reshape(B * J, Fr, C)
            if i == 0:
                h = h + self.Temporal_pos_embed
            h = self.Temporal_norm(self._block(mm, self.TTEblocks[i], h, masks.get(f"tte_{i}")))
            h = h.view(B, J, Fr, C).transpose(1, 2).reshape(B * Fr, J, C)
        x = self.head[0](h.view(B, Fr, J, C))
        return self._linear(mm, self.head[1], x)


def build(model_cfg, weights, dtype=torch.float64, device=None):
    """A MixSTE2 of `model_cfg` (the configuration file's "model") holding
    `weights` {state_dict key: tensor} in `dtype`."""
    with torch.device(device or "cpu"):
        m = MixSTE2(model_cfg["num_frames"], model_cfg["num_joints"], model_cfg["embed_dim"],
                    model_cfg["depth"], model_cfg["num_heads"], model_cfg["mlp_ratio"],
                    model_cfg.get("in_chans", 2)).to(dtype)
    m.load_state_dict({k: v.detach() for k, v in weights.items()})
    return m


def droppath_rates(model_cfg):
    """The per-depth DropPath rates, linspace(0, rate, depth)."""
    return np.linspace(0, model_cfg["drop_path_rate"], model_cfg["depth"])

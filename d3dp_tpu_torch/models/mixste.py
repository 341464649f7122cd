"""MixSTE2 spatio-temporal transformer denoiser as a torch nn.Module.

Counterpart of d3dp_tpu/models/mixste.py `MixSTE2` on its fused path at
fuse level 4 (`mixste.py:742-761`): every block is the attention stage
(`ops.attention.attention_stage`) followed by the transposing MLP step
(`ops.mlp.mlp_block_t`), which also applies the shared spatial/temporal
LayerNorm and writes its output in the other stage's layout, so the network
has no standalone spatial<->temporal transposes. On CUDA tensors those ops
launch the hand-written kernels; on CPU tensors they run their plain torch
versions.

Module and parameter names are the original PyTorch MixSTE2's state_dict
keys (the ones d3dp_tpu/train/convert_torch.py reads), so original
checkpoints load with `load_state_dict`.

Precision: parameters are fp32; the trunk computes in `cfg.dtype` (fp32 or
bf16) with fp32 softmax and LayerNorm statistics; the regression head is
fp32. Parity quirks kept: exact-erf GELU, LN eps 1e-6 in the blocks and
1e-5 in the head, one shared spatial and one shared temporal norm after
every depth, the temporal position embedding added once after the first
spatial block.
"""

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from d3dp_tpu_torch.device import resolve_device
from d3dp_tpu_torch.ops import attention, mlp

BLOCK_EPS = 1e-6
HEAD_EPS = 1e-5


@dataclass(frozen=True)
class MixSTEConfig:
    num_frames: int = 243
    num_joints: int = 17
    in_chans: int = 2
    embed_dim: int = 512
    depth: int = 8
    num_heads: int = 8
    mlp_ratio: float = 2.0
    qk_scale: Optional[float] = None
    dtype: torch.dtype = torch.float32  # compute dtype (bf16 for the fast path)


def sinusoidal_time_embedding(t, dim):
    """Sinusoidal embeddings of diffusion timesteps, fp32. t: (B,) -> (B, dim).
    (reference: common/mixste.py:127-139)"""
    half = dim // 2
    freq = math.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -freq)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


class SinusoidalPosEmb(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return sinusoidal_time_embedding(t, self.dim)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class Attention(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class Block(nn.Module):
    """Parameter holder of one pre-LN block (norm1, attn, norm2, mlp)."""

    def __init__(self, dim, hidden):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.attn = Attention(dim)
        self.norm2 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.mlp = Mlp(dim, hidden)


class MixSTE2(nn.Module):
    """forward(x2d, x3d, t): x2d (B, F, J, in_chans) conditioning keypoints,
    x3d (B, F, J, 3) noisy pose, t (B,) timesteps -> (B, F, J, 3) fp32
    clean-pose prediction. Hypotheses and flip-TTA are folded into B by the
    sampler."""

    def __init__(self, cfg: MixSTEConfig, device=None, seed=0):
        super().__init__()
        self.cfg = cfg
        C, J, Fr = cfg.embed_dim, cfg.num_joints, cfg.num_frames
        hidden = int(C * cfg.mlp_ratio)
        self.Spatial_patch_to_embedding = nn.Linear(cfg.in_chans + 3, C)
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, J, C))
        self.Temporal_pos_embed = nn.Parameter(torch.zeros(1, Fr, C))
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(C), nn.Linear(C, 2 * C), nn.GELU(), nn.Linear(2 * C, C))
        self.STEblocks = nn.ModuleList(Block(C, hidden) for _ in range(cfg.depth))
        self.TTEblocks = nn.ModuleList(Block(C, hidden) for _ in range(cfg.depth))
        self.Spatial_norm = nn.LayerNorm(C, eps=BLOCK_EPS)
        self.Temporal_norm = nn.LayerNorm(C, eps=BLOCK_EPS)
        self.head = nn.Sequential(nn.LayerNorm(C, eps=HEAD_EPS), nn.Linear(C, 3))
        self._init_weights(seed)
        self.to(resolve_device(device))
        self.requires_grad_(False)  # eval-only in this port so far
        self._cache = None

    @torch.no_grad()
    def _init_weights(self, seed):
        """Linear weights N(0, 0.02) from an explicit generator, zero biases,
        unit LayerNorms, zero position embeddings (the reference's init,
        with a normal in place of its truncated normal)."""
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.02)
                m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()

    # -------------------------------------------------------- weight cache
    def invalidate_weight_cache(self):
        """Drop the cached compute-dtype weights; call after changing
        parameters in place (`load_state_dict` and `.to()` call it)."""
        self._cache = None

    def _apply(self, fn, *args, **kwargs):
        self.invalidate_weight_cache()
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, *args, **kwargs):
        self.invalidate_weight_cache()
        return super().load_state_dict(*args, **kwargs)

    @torch.no_grad()
    def _weights(self):
        """Kernel-layout weights, built once and cached: matrices transposed
        to (in, out) and cast to the compute dtype ONCE here, not on every
        DDIM step; biases and LayerNorm parameters stay fp32."""
        if self._cache is not None:
            return self._cache
        dt = self.cfg.dtype

        def mat(lin):
            return lin.weight.t().to(dt).contiguous()

        def vec(p):
            return p.detach().float().contiguous()

        def block(b):
            return dict(
                wqkv=mat(b.attn.qkv), bqkv=vec(b.attn.qkv.bias),
                wp=mat(b.attn.proj), bp=vec(b.attn.proj.bias),
                ln1s=vec(b.norm1.weight), ln1b=vec(b.norm1.bias),
                ln2s=vec(b.norm2.weight), ln2b=vec(b.norm2.bias),
                w1=mat(b.mlp.fc1), b1=vec(b.mlp.fc1.bias),
                w2=mat(b.mlp.fc2), b2=vec(b.mlp.fc2.bias))

        def linear(lin):  # (out, in) for F.linear, compute dtype
            return lin.weight.to(dt), lin.bias.to(dt)

        self._cache = dict(
            embed=linear(self.Spatial_patch_to_embedding),
            time1=linear(self.time_mlp[1]), time2=linear(self.time_mlp[3]),
            spatial_pos=self.Spatial_pos_embed.to(dt),
            temporal_pos=self.Temporal_pos_embed.to(dt),
            ste=[block(b) for b in self.STEblocks],
            tte=[block(b) for b in self.TTEblocks],
            spatial_norm=(vec(self.Spatial_norm.weight), vec(self.Spatial_norm.bias)),
            temporal_norm=(vec(self.Temporal_norm.weight), vec(self.Temporal_norm.bias)))
        return self._cache

    # -------------------------------------------------------------- forward
    def _block(self, w, h, out_norm, B):
        """One block on (B*D1, N, C): the attention stage, then the MLP step
        with the shared norm, emitted as (B*N, D1, C) in the other layout."""
        cfg = self.cfg
        R, N, C = h.shape
        D1 = R // B
        scale = cfg.qk_scale or (C // cfg.num_heads) ** -0.5
        x2, y2 = attention.attention_stage(
            h, w["wqkv"], w["bqkv"], w["wp"], w["bp"], w["ln1s"], w["ln1b"],
            w["ln2s"], w["ln2b"], cfg.num_heads, scale, BLOCK_EPS)
        out = mlp.mlp_block_t(
            y2.view(B, D1, N, C), x2.view(B, D1, N, C), w["w1"], w["b1"],
            w["w2"], w["b2"], out_norm[0], out_norm[1], BLOCK_EPS)
        return out.view(B * N, D1, C)

    def forward(self, x2d, x3d, t):
        cfg = self.cfg
        dt = cfg.dtype
        B, Fr, J, _ = x3d.shape
        C = cfg.embed_dim
        W = self._weights()

        x = F.linear(torch.cat([x2d, x3d], dim=-1).to(dt), *W["embed"])
        temb = sinusoidal_time_embedding(t, C).to(dt)
        temb = F.gelu(F.linear(temb, *W["time1"]), approximate="none")
        temb = F.linear(temb, *W["time2"])
        x = x + W["spatial_pos"]  # (1, J, C) over (B, F, J, C)
        x = x + temb[:, None, None, :]

        # transpose-free flow: each block leaves its output in the next
        # stage's layout, (B*F, J, C) <-> (B*J, F, C)
        h = x.reshape(B * Fr, J, C)
        for i in range(cfg.depth):
            h = self._block(W["ste"][i], h, W["spatial_norm"], B)
            if i == 0:
                h = h + W["temporal_pos"]  # (B*J, F, C) + (1, F, C)
            h = self._block(W["tte"][i], h, W["temporal_norm"], B)
        x = h.view(B, Fr, J, C)

        ln, head = self.head[0], self.head[1]
        x = F.layer_norm(x.float(), (C,), ln.weight, ln.bias, HEAD_EPS).to(dt)
        return F.linear(x.float(), head.weight, head.bias)  # fp32 head

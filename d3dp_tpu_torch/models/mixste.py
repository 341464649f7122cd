"""MixSTE2 spatio-temporal transformer denoiser as a torch nn.Module.

Counterpart of d3dp_tpu/models/mixste.py `MixSTE2` with
`attention_impl="pallas"` at fuse levels 0 to 5:

* eval (`train=False`) dispatches on `cfg.fuse_level`, as the JAX package's
  ladder (`mixste.py:469-565`, flows `:742-788`) does:
  - 0: the composed block below, without DropPath (attention core K3).
  - 1: per block, LN1 and the qkv projection as plain ops, the attention
    core (`ops.attention.fused_attention_qkv`), the out-projection, residual
    and LN2 as plain ops, then the MLP half with the shared
    spatial/temporal norm in one kernel (`ops.mlp.mlp_block`); the
    spatial<->temporal relayouts and the temporal position embedding are
    plain ops (`:762-788`).
  - 2: as 1, with the attention, out-projection, residual and LN2 in one
    kernel (`ops.attention.attention_block`).
  - 3: the transpose-free flow (`:742-761`): as 2, with the MLP step
    writing its output in the other stage's layout (`ops.mlp.mlp_block_t`).
  - 4 (the default): the transpose-free flow with the whole attention half
    in one kernel (`ops.attention.attention_stage`; under the `hmqkv` lab
    variant the head-major stage `ops.attention.attention_stage_hm`, with
    its stacked weights cached).
  - 5: the whole 2 x depth trunk in one kernel launch
    (`ops.resident.resident_block_stack`, `mixste.py:707-741`); with DDIM
    feature reuse taps it takes level 4's flow, as the JAX package does.
  Levels 1-5 read kernel-layout weights from a cast cache, without
  autograd.
* DDIM feature reuse (eval only, `reuse_tap` / `deep_delta` in `forward`):
  taps at block-pair boundaries in the (B, F, J, C) layout, after the shared
  norms, in every flow (`mixste.py:583-606`).
* training (`train=True`): by default, at every level, the composed block
  (`mixste.py:427-467`), with autograd: pre-LN, qkv projection, the attention
  core (`ops.attention.fused_attention_qkv_ad`, whose backward is a kernel
  too), out-projection, MLP, per-row DropPath scales, then the shared norm
  and the spatial<->temporal relayout as plain ops. The block's four
  linears (qkv, proj, fc1, fc2) go through `ops.linear.linear`: in fp32 on
  a card their forward and input gradient run on the tf32x3 GEMM kernel
  (also at eval level 0 and in the tp partial products, whose operands are
  fp32), otherwise `F.linear`.
  With `D3DP_TRAIN_FUSED=1` (the JAX package's lab switch, `:406-426`) and
  fuse level >= 1, each block takes its level's fused ops through their
  autograd Functions (`*_ad`, backwards in plain ops around the attention
  core's kernels) where the JAX `Block` does: every block at level >= 4
  (level 5 trains as 4: its kernel is eval-only), active DropPath riding
  the `*_dp` ops as per-row branch scales; at levels 1-3 only the blocks
  whose DropPath rate is 0, the others composed. Weights go through
  autograd in kernel layout.

* tensor parallel (`parallel.mesh.shard_params`, `--tp`): the model holds
  its rank's head-aligned shares of qkv, fc1 and the time MLP's first layer
  and the matching input columns of the out-projection, fc2 and the time
  MLP's second layer (`self.tp`). The composed path (level 0, training)
  runs the column-parallel layers on `parallel.tp.copy_to_tp` of their
  input and sums the row-parallel ones' fp32 partials with
  `reduce_from_tp` before their bias; the attention core runs on the
  rank's heads. Evaluation at levels 1-5 (and level 5's reuse flow) runs
  the one-process flow, the whole kernels, on the tp group's gathered
  weights, gathered once per weight version into the `_weights` cache: the
  JAX package's ops have no partitioning of their own, so under its ('dp',
  'tp') mesh XLA runs each Pallas call whole on gathered operands, and
  every rank then computes what one process computes, bit for bit.
  `D3DP_TRAIN_FUSED=1` trains through the partial forms' autograd
  Functions (`attention_stage_partial_ad` at 4, K8-tp inside it under
  `hmqkv`, `attention_block_partial_ad` at 2-3, `mlp_block_partial_ad`) and
  `ops.residual_ln.residual_ln_ad`, whose DropPath scale makes each half
  what K1-dp and K2-dp compute (`_train_block_fused_tp`): the operands a
  partial form reads whole (the block's input, LN1's parameters, LN2's
  output) pass `copy_to_tp`, so their gradients sum over the group; the
  bias, residual and norm after the sum get their whole gradient on every
  rank. The DropPath masks are drawn per step from one generator state, so
  the ranks of a tp group draw the same ones.

On CUDA tensors the ops launch the hand-written kernels; on CPU tensors
they run their plain torch versions.

Module and parameter names are the original PyTorch MixSTE2's state_dict
keys (the ones d3dp_tpu/train/convert_torch.py reads), so original
checkpoints load with `load_state_dict`.

Precision (flax's `Dense(dtype=...)` policy): parameters are fp32; the trunk
computes in `cfg.dtype` (fp32 or bf16): operands are cast to it, each
layer's output and the residual stream are in it, softmax and LayerNorm
statistics are fp32; the regression head is fp32. Parity quirks kept:
exact-erf GELU, LN eps 1e-6 in the blocks and 1e-5 in the head, one shared
spatial and one shared temporal norm after every depth, the temporal
position embedding added once after the first spatial block.
"""

import math
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from d3dp_tpu_torch.device import resolve_device
from d3dp_tpu_torch.ops import attention, mlp, resident, tf32
from d3dp_tpu_torch.ops.linear import linear
from d3dp_tpu_torch.ops.residual_ln import residual_ln_ad
from d3dp_tpu_torch.parallel.mesh import gather_params
from d3dp_tpu_torch.parallel.tp import copy_to_tp, reduce_from_tp

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
    drop_path_rate: float = 0.0  # stochastic depth, training only
    dtype: torch.dtype = torch.float32  # compute dtype (bf16 for the fast path)
    fuse_level: int = 4  # the eval path's kernel ladder, 0..5 (module docstring)

    def __post_init__(self):
        if self.fuse_level not in range(6):
            raise ValueError(f"fuse_level must be 0..5, got {self.fuse_level}")

    @property
    def attn_scale(self):
        return self.qk_scale or (self.embed_dim // self.num_heads) ** -0.5


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


def _linear(lin, x):
    """A block's nn.Linear in x's dtype: fp32 parameters cast to it
    (differentiably); fp32 on a card on the tf32x3 kernel (`ops.linear`)."""
    return linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _cast_linear(lin, dt):
    """(weight, bias) of an nn.Linear in dtype dt, (out, in) for F.linear."""
    return lin.weight.to(dt), lin.bias.to(dt)


def _cast_named(P, name, dt):
    """(weight, bias) of the linear layer `name` in the parameters P {name:
    tensor}, in dtype dt, (out, in) for F.linear."""
    return P[f"{name}.weight"].to(dt), P[f"{name}.bias"].to(dt)


def _row_parallel(x, w, b, group, product=linear):
    """product(x, w, b) in x's dtype, w and b in it; under a tp `group`, w
    holds the rank's input columns: the fp32 partial products summed over
    the group, the bias added once, after the sum. product: `ops.linear`'s
    (the blocks' proj and fc2) or F.linear (the time MLP)."""
    if group is None:
        return product(x, w, b)
    part = product(x.float(), w.float())
    return (reduce_from_tp(part, group) + b.float()).to(x.dtype)


def _swap_stages(h, B):
    """(B*D1, N, C) -> (B*N, D1, C), the other stage's layout, contiguous:
    at B = 1 the reshape alone returns a strided view, which the kernels
    refuse."""
    R, N, C = h.shape
    return h.view(B, R // B, N, C).transpose(1, 2).reshape(B * N, R // B, C).contiguous()


def _layer_norm(norm, x):
    """LayerNorm in fp32 (statistics, parameters, and the backward's sums),
    output rounded to x's dtype, as flax's LayerNorm(dtype=...) computes."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias,
                        norm.eps).to(x.dtype)


class Mlp(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.tp_group = None  # the tp group once split (`shard_params`)

    def forward(self, x):
        h = F.gelu(_linear(self.fc1, copy_to_tp(x, self.tp_group)), approximate="none")
        return _row_parallel(h, *_cast_linear(self.fc2, h.dtype), self.tp_group)


class Attention(nn.Module):
    def __init__(self, dim, num_heads, scale):
        super().__init__()
        self.num_heads, self.scale = num_heads, scale
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.tp_group = None  # the tp group once split; num_heads is then the rank's

    def forward(self, x):
        qkv = _linear(self.qkv, copy_to_tp(x, self.tp_group))
        o = attention.fused_attention_qkv_ad(qkv, self.num_heads, self.scale)
        return _row_parallel(o, *_cast_linear(self.proj, o.dtype), self.tp_group)


class Block(nn.Module):
    """One pre-LN block (norm1, attn, norm2, mlp). `forward` is the composed
    training path; the eval path reads the parameters through
    `MixSTE2._weights`."""

    def __init__(self, dim, hidden, num_heads, scale):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.attn = Attention(dim, num_heads, scale)
        self.norm2 = nn.LayerNorm(dim, eps=BLOCK_EPS)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x, masks=None):
        """x: (R, N, C) in the compute dtype. masks: None or the two per-row
        DropPath scale vectors (R,) fp32, one per residual branch."""
        dt = x.dtype
        a = self.attn(_layer_norm(self.norm1, x))
        if masks is not None:
            a = (a * masks[0][:, None, None]).to(dt)
        x = x + a
        h = self.mlp(_layer_norm(self.norm2, x))
        if masks is not None:
            h = (h * masks[1][:, None, None]).to(dt)
        return x + h


class MixSTE2(nn.Module):
    """forward(x2d, x3d, t, train=False, ...): x2d (B, F, J, in_chans)
    conditioning keypoints, x3d (B, F, J, 3) noisy pose, t (B,) timesteps ->
    (B, F, J, 3) fp32 clean-pose prediction. Hypotheses and flip-TTA are
    folded into B by the sampler."""

    def __init__(self, cfg: MixSTEConfig, device=None, seed=0):
        super().__init__()
        self.cfg = cfg
        C, J, Fr = cfg.embed_dim, cfg.num_joints, cfg.num_frames
        hidden = int(C * cfg.mlp_ratio)
        scale = cfg.attn_scale
        self.Spatial_patch_to_embedding = nn.Linear(cfg.in_chans + 3, C)
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, J, C))
        self.Temporal_pos_embed = nn.Parameter(torch.zeros(1, Fr, C))
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(C), nn.Linear(C, 2 * C), nn.GELU(), nn.Linear(2 * C, C))
        self.STEblocks = nn.ModuleList(
            Block(C, hidden, cfg.num_heads, scale) for _ in range(cfg.depth))
        self.TTEblocks = nn.ModuleList(
            Block(C, hidden, cfg.num_heads, scale) for _ in range(cfg.depth))
        self.Spatial_norm = nn.LayerNorm(C, eps=BLOCK_EPS)
        self.Temporal_norm = nn.LayerNorm(C, eps=BLOCK_EPS)
        self.head = nn.Sequential(nn.LayerNorm(C, eps=HEAD_EPS), nn.Linear(C, 3))
        self._init_weights(seed)
        self.to(resolve_device(device))
        self._cache = None
        self._cache_key = None
        self.tp = None  # a parallel.mesh.TensorParallel once split (`shard_params`)

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
    def _apply(self, fn, *args, **kwargs):
        self._cache = None  # `.to()` and friends may reuse freed storage
        return super()._apply(fn, *args, **kwargs)

    def _front_weights(self, P=None):
        """Embedding, time-MLP and spatial position weights in the compute
        dtype, (out, in) for F.linear, from the parameters P {name: tensor}
        (default: the model's own)."""
        dt = self.cfg.dtype
        P = dict(self.named_parameters()) if P is None else P
        return dict(embed=_cast_named(P, "Spatial_patch_to_embedding", dt),
                    time1=_cast_named(P, "time_mlp.1", dt),
                    time2=_cast_named(P, "time_mlp.3", dt),
                    spatial_pos=P["Spatial_pos_embed"].to(dt))

    @torch.no_grad()
    def _weights(self):
        """Kernel-layout weights of the eval path, cached: matrices
        transposed to (in, out) and cast to the compute dtype once, not on
        every DDIM step; biases and LayerNorm parameters stay fp32. Each
        kind's weights are stacked along depth in the level-5 kernel's
        layout (`resident`); the per-block entries of levels 1-4 (`ste`,
        `tte`) are views into those stacks, beside each block's head-major
        qkv stacks (`hm`, for the `hmqkv` variant). The cache is keyed on
        every parameter's storage and version counter, so it is rebuilt
        after any change to a parameter: an optimizer step,
        `load_state_dict`, or an in-place edit. Under tp (`self.tp`) it is
        built from the tp group's gathered weights (a collective over the
        group, once per weight version), so every rank runs one process's
        kernels on one process's weights. In fp32 the cache also holds the
        fp32 kernels' weight operands, the matrices' TF32 hi and lo planes
        in nn.Linear's (out, in) layout (`ops.tf32.planes`), which the ops
        take as `planes`: the depth stacks' (`resident_planes`), each
        block's views of those and its head-major qkv's (`planes`; None in
        bf16)."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if self._cache is not None and self._cache_key == key:
            return self._cache
        cfg = self.cfg
        dt = cfg.dtype
        P = dict(self.named_parameters()) if self.tp is None else gather_params(self)

        f32 = dt == torch.float32

        def views(stacked, planes, prefix):
            wqkv, bqkv, wp, w1, b1, w2, v = stacked
            out = []
            for i in range(cfg.depth):
                w = dict(qkv_linear=_cast_named(P, f"{prefix}.{i}.attn.qkv", dt),
                         proj_linear=_cast_named(P, f"{prefix}.{i}.attn.proj", dt),
                         wqkv=wqkv[i], bqkv=bqkv[i, 0], wp=wp[i], bp=v[i, 0],
                         ln1s=v[i, 1], ln1b=v[i, 2], ln2s=v[i, 3], ln2b=v[i, 4],
                         w1=w1[i], b1=b1[i, 0], w2=w2[i], b2=v[i, 5],
                         hm=attention.stack_head_major(wqkv[i], bqkv[i, 0], cfg.num_heads))
                if f32:
                    pq, pp, p1, p2 = (p[i] for p in planes)
                    w["planes"] = dict(stage=(pq, pp), block=(pp,), mlp=(p1, p2),
                                       hm=(tf32.planes(w["hm"][0]), pp))
                else:
                    w["planes"] = dict(stage=None, block=None, mlp=None, hm=None)
                out.append(w)
            return out

        spatial, temporal = self._stack(P, "STEblocks"), self._stack(P, "TTEblocks")
        # fp32: the planes of each kind's (wqkv, wp, w1, w2) stacks
        planes = tuple(tuple(tf32.planes(stacked[k]) for k in (0, 2, 3, 5)) if f32 else None
                       for stacked in (spatial, temporal))
        norms = torch.stack([P["Spatial_norm.weight"], P["Spatial_norm.bias"],
                             P["Temporal_norm.weight"], P["Temporal_norm.bias"]]).float()
        self._cache_key = key
        self._cache = dict(
            **self._front_weights(P),
            temporal_pos=P["Temporal_pos_embed"].to(dt),
            ste=views(spatial, planes[0], "STEblocks"),
            tte=views(temporal, planes[1], "TTEblocks"),
            resident=(spatial, temporal, norms),
            resident_planes=planes if f32 else None,
            spatial_norm=(norms[0], norms[1]),
            temporal_norm=(norms[2], norms[3]))
        return self._cache

    def _stack(self, P, prefix):
        """(wqkv, bqkv, wp, w1, b1, w2, vec) of `resident_block_stack` from
        the parameters P {name: tensor} of blocks `prefix`.i, each kind
        stacked along depth, matrices (in, out) in the compute dtype."""
        dt, depth = self.cfg.dtype, self.cfg.depth

        def mats(name):
            return torch.stack([P[f"{prefix}.{i}.{name}.weight"].t().to(dt)
                                for i in range(depth)])

        def vecs(*names):
            return torch.stack([torch.stack([P[f"{prefix}.{i}.{n}"] for n in names])
                                for i in range(depth)]).float()

        return (mats("attn.qkv"), vecs("attn.qkv.bias"), mats("attn.proj"), mats("mlp.fc1"),
                vecs("mlp.fc1.bias"), mats("mlp.fc2"),
                vecs("attn.proj.bias", "norm1.weight", "norm1.bias", "norm2.weight",
                     "norm2.bias", "mlp.fc2.bias"))

    # -------------------------------------------------------------- forward
    def _attention_half(self, w, blk, h):
        """(x2, y2) of one block's attention half on (R, N, C) at the
        configured fuse level (1-4, and level 5's reuse flow): x2 = h +
        attention branch, y2 = LN2(x2)."""
        cfg = self.cfg
        scale = cfg.attn_scale
        if cfg.fuse_level >= 4:
            if attention.stage_config(h)[0] == "head_major":
                return attention.attention_stage_hm(
                    h, *w["hm"], w["wp"], w["bp"], w["ln1s"], w["ln1b"], w["ln2s"],
                    w["ln2b"], cfg.num_heads, scale, BLOCK_EPS, planes=w["planes"]["hm"])
            return attention.attention_stage(
                h, w["wqkv"], w["bqkv"], w["wp"], w["bp"], w["ln1s"], w["ln1b"],
                w["ln2s"], w["ln2b"], cfg.num_heads, scale, BLOCK_EPS,
                planes=w["planes"]["stage"])
        qkv = F.linear(_layer_norm(blk.norm1, h), *w["qkv_linear"])
        if cfg.fuse_level >= 2:
            return attention.attention_block(qkv, h, w["wp"], w["bp"], w["ln2s"], w["ln2b"],
                                             cfg.num_heads, scale, BLOCK_EPS,
                                             planes=w["planes"]["block"])
        o = attention.fused_attention_qkv(qkv, cfg.num_heads, scale)
        x2 = h + F.linear(o, *w["proj_linear"])
        return x2, _layer_norm(blk.norm2, x2)

    def _block(self, w, blk, h, out_norm, B):
        """One block on (B*D1, N, C): the attention half, then the MLP step
        with the shared norm. Levels 3-5 emit (B*N, D1, C) in the other
        stage's layout; levels 1 and 2 keep the layout."""
        R, N, C = h.shape
        x2, y2 = self._attention_half(w, blk, h)
        if self.cfg.fuse_level <= 2:
            out = mlp.mlp_block(y2.view(R * N, C), x2.view(R * N, C), w["w1"], w["b1"],
                                w["w2"], w["b2"], out_norm[0], out_norm[1], BLOCK_EPS,
                                planes=w["planes"]["mlp"])
            return out.view(R, N, C)
        D1 = R // B
        out = mlp.mlp_block_t(
            y2.view(B, D1, N, C), x2.view(B, D1, N, C), w["w1"], w["b1"],
            w["w2"], w["b2"], out_norm[0], out_norm[1], BLOCK_EPS, planes=w["planes"]["mlp"])
        return out.view(B * N, D1, C)

    def _embed(self, x2d, x3d, t, W, whole=False):
        """Joint embedding + spatial position + time embedding -> (B, F, J, C)
        in the compute dtype. Under tp the time MLP is split over the group
        (its second layer's partials summed), unless `whole`: W holds the
        whole weights (the eval cache's, gathered over the group)."""
        dt = self.cfg.dtype
        group = None if self.tp is None or whole else self.tp.group
        x = F.linear(torch.cat([x2d, x3d], dim=-1).to(dt), *W["embed"])
        temb = sinusoidal_time_embedding(t, self.cfg.embed_dim).to(dt)
        temb = F.gelu(F.linear(copy_to_tp(temb, group), *W["time1"]), approximate="none")
        temb = _row_parallel(temb, *W["time2"], group, product=F.linear)
        x = x + W["spatial_pos"]  # (1, J, C) over (B, F, J, C)
        return x + temb[:, None, None, :]

    def _head(self, x):
        """Head LayerNorm (eps 1e-5, output in the compute dtype), then the
        fp32 regression head."""
        ln, head = self.head[0], self.head[1]
        x = F.layer_norm(x.float(), (self.cfg.embed_dim,), ln.weight, ln.bias, HEAD_EPS)
        return F.linear(x.to(self.cfg.dtype).float(), head.weight, head.bias)

    def forward(self, x2d, x3d, t, train=False, generator=None, droppath_masks=None,
                drop_path=True, reuse_tap=None, deep_delta=None):
        """train=False (the JAX `deterministic=True`): the eval path at
        `cfg.fuse_level`, which has no backward (at level 0 it runs the
        composed path under no_grad, without DropPath). train=True: the
        composed path with autograd (or, with `D3DP_TRAIN_FUSED=1` at fuse
        level >= 1, the fused ops with their backwards; module docstring)
        and, where `cfg.drop_path_rate` > 0 and `drop_path`, DropPath. Its
        masks are drawn from `generator` (a torch.Generator on the model's
        device), or taken from `droppath_masks` = {"ste_i" / "tte_i": (m1,
        m2)}, each (rows,) fp32, for every block whose rate is above 0
        (parity tests). train=True with drop_path=False is the deterministic
        function with a backward.

        DDIM feature reuse (eval only; `diffusion/d3dp.py`):
          * reuse_tap=d, deep_delta=None ("full" call): every block runs, and
            the call returns (out, delta), delta being the (B, F, J, C)
            stream after the last block pair minus the stream after pair
            d-1, in the compute dtype;
          * reuse_tap=d, deep_delta=delta ("reuse" call): only pairs 0..d-1
            run, the final stream is their output plus delta, then the head.
        """
        if reuse_tap is not None:
            if not 1 <= reuse_tap <= self.cfg.depth:
                raise ValueError(f"reuse_tap must be 1..{self.cfg.depth}, got {reuse_tap}")
            if train:
                raise ValueError("feature reuse is an eval-only mode")
        elif deep_delta is not None:
            raise ValueError("deep_delta needs reuse_tap")
        if train:
            fused = (self.cfg.fuse_level >= 1
                     and os.environ.get("D3DP_TRAIN_FUSED", "0") == "1")
            x, _ = self._trunk_composed(x2d, x3d, t, generator, droppath_masks, drop_path,
                                        fused=fused)
            return self._head(x)
        with torch.no_grad():
            if self.cfg.fuse_level == 0:
                x, tap = self._trunk_composed(x2d, x3d, t, None, None, False, reuse_tap,
                                              deep_delta)
            else:
                x, tap = self._trunk_fused(x2d, x3d, t, reuse_tap, deep_delta)
            out = self._head(x)
        if reuse_tap is not None and deep_delta is None:
            return out, x - tap
        return out

    def _pairs(self, x, pair, reuse_tap, deep_delta):
        """Run the block pairs, pair(i, h) -> h on (B*F, J, C), on the
        (B, F, J, C) stream x: all of them, or with `deep_delta` pairs
        0..reuse_tap-1 only, the cached delta added to their output.
        Returns (the stream after the trunk, the stream after pair
        reuse_tap-1 or None), both (B, F, J, C)."""
        h, tap = x.reshape(-1, *x.shape[2:]), None
        for i in range(reuse_tap if deep_delta is not None else self.cfg.depth):
            h = pair(i, h)
            if reuse_tap == i + 1:
                tap = h.view(x.shape)
        if deep_delta is not None:
            return tap + deep_delta.to(tap.dtype), tap
        return h.view(x.shape), tap

    def _trunk_fused(self, x2d, x3d, t, reuse_tap, deep_delta):
        """The fused eval flow at cfg.fuse_level 1-5: (stream after the
        trunk, tap stream or None), both (B, F, J, C)."""
        cfg = self.cfg
        B = x3d.shape[0]
        W = self._weights()
        x = self._embed(x2d, x3d, t, W, whole=True)
        if cfg.fuse_level == 5 and reuse_tap is None:
            return resident.resident_block_stack(
                x, W["temporal_pos"][0], *W["resident"], cfg.num_heads, cfg.attn_scale,
                BLOCK_EPS, planes=W["resident_planes"]), None
        ste, tte = list(zip(W["ste"], self.STEblocks)), list(zip(W["tte"], self.TTEblocks))
        if cfg.fuse_level >= 3:
            # transpose-free flow: each block leaves its output in the next
            # stage's layout, (B*F, J, C) <-> (B*J, F, C)
            def pair(i, h):
                h = self._block(*ste[i], h, W["spatial_norm"], B)
                if i == 0:
                    h = h + W["temporal_pos"]  # (B*J, F, C) + (1, F, C)
                return self._block(*tte[i], h, W["temporal_norm"], B)
        else:
            # levels 1 and 2: the relayouts as plain ops between the blocks
            def pair(i, h):
                h = self._block(*ste[i], h, W["spatial_norm"], B)
                h = _swap_stages(h, B)
                if i == 0:
                    h = h + W["temporal_pos"]
                h = self._block(*tte[i], h, W["temporal_norm"], B)
                return _swap_stages(h, B)
        return self._pairs(x, pair, reuse_tap, deep_delta)

    def _droppath_masks(self, name, rate, n_rows, generator, given):
        """The two per-row DropPath scale vectors of one block (1/keep where
        kept, 0 where dropped; `mixste.py:383-396`), or None at rate 0."""
        if rate <= 0.0:
            return None
        dev = self.Spatial_pos_embed.device
        if given is not None:
            return tuple(torch.as_tensor(m, dtype=torch.float32, device=dev)
                         for m in given[name])
        if generator is None:
            raise ValueError("DropPath needs a torch.Generator or droppath_masks")
        keep = 1.0 - rate

        def draw():
            u = torch.rand(n_rows, generator=generator, device=dev)
            return torch.where(u < keep, 1.0 / keep, 0.0)
        return draw(), draw()

    def draw_droppath_masks(self, B, generator, rows=slice(None)):
        """The DropPath masks of a training forward on a batch of B, drawn
        from `generator` in the order that forward draws them, as the
        `droppath_masks` dict. `rows`: the batch rows to keep (a
        data-parallel rank draws for the global batch and keeps its own);
        spatial rows are b-major (B*F), temporal ones B*J."""
        cfg = self.cfg
        rates = np.linspace(0, cfg.drop_path_rate, cfg.depth)
        out = {}
        for i, rate in enumerate(rates):
            for kind, per in (("ste", cfg.num_frames), ("tte", cfg.num_joints)):
                masks = self._droppath_masks(f"{kind}_{i}", float(rate), B * per, generator, None)
                if masks is not None:
                    out[f"{kind}_{i}"] = tuple(m.view(B, per)[rows].reshape(-1) for m in masks)
        return out

    def _trunk_composed(self, x2d, x3d, t, generator, droppath_masks, drop_path,
                        reuse_tap=None, deep_delta=None, fused=False):
        """The composed flow: (stream after the trunk, tap stream or None),
        both (B, F, J, C). fused: the training flow of `D3DP_TRAIN_FUSED=1`,
        where the blocks that the JAX `Block` sends to its fused path take
        `_train_block_fused`."""
        cfg = self.cfg
        B = x3d.shape[0]
        rates = np.linspace(0, cfg.drop_path_rate if drop_path else 0.0, cfg.depth)
        x = self._embed(x2d, x3d, t, self._front_weights())

        def block(kind, i, h, norm):
            """Block, shared norm, then the relayout (B*D1, N, C) ->
            (B*N, D1, C) into the other stage's layout."""
            masks = self._droppath_masks(f"{kind}_{i}", float(rates[i]), h.shape[0],
                                         generator, droppath_masks)
            blocks = self.STEblocks if kind == "ste" else self.TTEblocks
            if fused and (masks is None or cfg.fuse_level >= 4):
                if self.tp is not None:
                    return self._train_block_fused_tp(blocks[i], h, norm, masks, B)
                return self._train_block_fused(blocks[i], h, norm, masks, B)
            return _swap_stages(_layer_norm(norm, blocks[i](h, masks)), B)

        def pair(i, h):
            h = block("ste", i, h, self.Spatial_norm)
            if i == 0:
                h = h + self.Temporal_pos_embed.to(cfg.dtype)
            return block("tte", i, h, self.Temporal_norm)

        return self._pairs(x, pair, reuse_tap, deep_delta)

    def _train_block_fused(self, blk, h, norm, masks, B):
        """One block of the `D3DP_TRAIN_FUSED=1` training flow on (B*D1, N,
        C), as the JAX `Block._fused` runs it at cfg.fuse_level (5 as 4),
        through the ops' autograd Functions; returns (B*N, D1, C) in the
        other stage's layout, the shared norm applied. masks: the block's two
        DropPath scale vectors (R,) or None (level >= 4 only)."""
        cfg = self.cfg
        R, N, C = h.shape
        D1 = R // B
        level = min(cfg.fuse_level, 4)
        scale = cfg.attn_scale
        dp_attn, dp_mlp = masks if masks is not None else (None, None)
        mat = self._mat

        if level >= 4:
            stage = (h, mat(blk.attn.qkv), blk.attn.qkv.bias, mat(blk.attn.proj),
                     blk.attn.proj.bias, blk.norm1.weight, blk.norm1.bias, blk.norm2.weight,
                     blk.norm2.bias)
            if dp_attn is None:
                x2, y2 = attention.attention_stage_ad(*stage, cfg.num_heads, scale, BLOCK_EPS)
            else:
                x2, y2 = attention.attention_stage_dp_ad(*stage, dp_attn, cfg.num_heads, scale,
                                                         BLOCK_EPS)
        elif level >= 2:
            qkv = _linear(blk.attn.qkv, _layer_norm(blk.norm1, h))
            x2, y2 = attention.attention_block_ad(
                qkv, h, mat(blk.attn.proj), blk.attn.proj.bias, blk.norm2.weight,
                blk.norm2.bias, cfg.num_heads, scale, BLOCK_EPS)
        else:
            x2 = h + blk.attn(_layer_norm(blk.norm1, h))
            y2 = _layer_norm(blk.norm2, x2)
        w = (mat(blk.mlp.fc1), blk.mlp.fc1.bias, mat(blk.mlp.fc2), blk.mlp.fc2.bias,
             norm.weight, norm.bias)
        if level <= 2:
            out = mlp.mlp_block_ad(y2.reshape(R * N, C), x2.reshape(R * N, C), *w, BLOCK_EPS)
            return _swap_stages(out.view(R, N, C), B)
        y2, x2 = y2.view(B, D1, N, C), x2.view(B, D1, N, C)
        if dp_mlp is None:
            out = mlp.mlp_block_t_ad(y2, x2, *w, BLOCK_EPS)
        else:
            out = mlp.mlp_block_t_dp_ad(y2, x2, *w, dp_mlp.view(B, D1), BLOCK_EPS)
        return out.view(B * N, D1, C)

    def _mat(self, lin):
        """An nn.Linear's weight in the kernels' (in, out) layout in the
        compute dtype, through autograd."""
        return lin.weight.t().contiguous().to(self.cfg.dtype)

    def _train_block_fused_tp(self, blk, h, norm, masks, B):
        """`_train_block_fused` on a rank of the tp group: each half's
        partial form over the rank's heads or hidden units with its
        backward (K1-tp at level 4, or K8-tp under `hmqkv`; K6-tp at 2-3; the
        composed tp attention at 1; K2/K5-tp), the fp32 partials summed over
        the group, then `residual_ln_ad` with the block's DropPath scale
        (the DropPath forms' math: K1-dp, K2-dp). Operands that a partial
        form reads whole pass `copy_to_tp`: their gradients, the ranks'
        shares, sum over the group."""
        cfg = self.cfg
        R, N, C = h.shape
        D1 = R // B
        level = min(cfg.fuse_level, 4)
        heads, scale, group = blk.attn.num_heads, cfg.attn_scale, self.tp.group
        dp_attn, dp_mlp = masks if masks is not None else (None, None)
        mat = self._mat
        if level >= 2:
            if level >= 4:
                part = attention.attention_stage_partial_ad(
                    copy_to_tp(h, group), mat(blk.attn.qkv), blk.attn.qkv.bias,
                    copy_to_tp(blk.norm1.weight, group), copy_to_tp(blk.norm1.bias, group),
                    mat(blk.attn.proj), heads, scale, BLOCK_EPS)
            else:
                qkv = _linear(blk.attn.qkv, copy_to_tp(_layer_norm(blk.norm1, h), group))
                part = attention.attention_block_partial_ad(qkv, mat(blk.attn.proj), heads, scale)
            x2, y2 = residual_ln_ad(h, reduce_from_tp(part, group), blk.attn.proj.bias,
                                    blk.norm2.weight, blk.norm2.bias, BLOCK_EPS, dp=dp_attn)
        else:
            x2 = h + blk.attn(_layer_norm(blk.norm1, h))
            y2 = _layer_norm(blk.norm2, x2)
        part = mlp.mlp_block_partial_ad(copy_to_tp(y2.reshape(R * N, C), group),
                                        mat(blk.mlp.fc1), blk.mlp.fc1.bias, mat(blk.mlp.fc2))
        part = reduce_from_tp(part, group).view(B, D1, N, C)
        out = residual_ln_ad(x2.view(B, D1, N, C), part, blk.mlp.fc2.bias, norm.weight,
                             norm.bias, BLOCK_EPS, with_x2=False, transpose=level >= 3,
                             dp=None if dp_mlp is None else dp_mlp.view(B, D1))
        if level >= 3:
            return out.view(B * N, D1, C)
        return _swap_stages(out.view(R, N, C), B)

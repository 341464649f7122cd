"""The ('dp', 'tp') mesh over torch.distributed ranks, and the
tensor-parallel split of MixSTE2's parameters.

Counterpart of d3dp_tpu/parallel/mesh.py. JAX builds one `Mesh` in one
process over every local device and lets XLA insert the collectives. Here
a rank is one process that drives one device, as DistributedDataParallel
expects, and the ranks are laid out as JAX lays out the devices,
`np.asarray(devices).reshape(dp, tp)`: rank r has `dp_index` r // tp and
`tp_index` r % tp, and a tp group is tp consecutive ranks. The ranks of a
tp group hold the same rows of a global batch (rows split by `dp_index`),
the same noise and the same DropPath masks; the callers reduce across
ranks with `all_reduce` and `broadcast` only (gloo takes CUDA tensors for
those two, so two ranks can share one card over gloo): over the dp group
for the rows and the gradients, over the tp group for the layers' partial
sums (`parallel.tp`). Where a gather is needed, each rank writes its share
into a zero buffer of the global shape and the buffer is all-reduced.

The tp split follows JAX's `_leaf_spec` by parameter name
(`mixste_param_spec`): the qkv, fc1 and time-MLP fc1 layers are
column-parallel, the attention out-projection, fc2 and time-MLP fc2
row-parallel, everything else replicated. A process has to compute with
its shard, so qkv is split by head within each of q, k and v (a rank gets
heads j h/tp .. (j+1) h/tp - 1 of each, with their bias thirds), where
JAX's P(None, 'tp') on the packed (C, 3C) kernel splits the 3C axis
contiguously and leaves the layout to GSPMD; the row-parallel biases stay
whole and are added once, after the sum. `shard_params` replaces a
module's parameters in place with the rank's slices (so an optimizer and
DistributedDataParallel built afterwards see shards), `gather_params` is
its inverse; checkpoints hold the whole parameters, so they are free of
topology. `replicate_stray_leaves` has no counterpart: each rank's
optimizer state lives beside its own parameters.
"""

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A ('dp', 'tp') mesh: one rank per device, `devices[r]` rank r's.
    dp_group: the ranks of this rank's tp index (None: the whole world, at
    tp 1); tp_group: the ranks of its dp index (None at tp 1)."""

    dp: int
    tp: int
    rank: int
    devices: Tuple[torch.device, ...]
    dp_group: Optional[Any] = None
    tp_group: Optional[Any] = None

    @property
    def shape(self):
        return {"dp": self.dp, "tp": self.tp}

    @property
    def size(self):
        return self.dp * self.tp

    @property
    def device(self):
        """This rank's device."""
        return self.devices[self.rank]

    @property
    def dp_index(self):
        return self.rank // self.tp

    @property
    def tp_index(self):
        return self.rank % self.tp


def make_mesh(dp=None, tp=1, devices=None):
    """Build a ('dp', 'tp') mesh over the ranks of the running process
    group, `devices` one entry per rank (default: rank r drives card r
    modulo the visible count). dp defaults to len(devices) // tp. At tp > 1
    every rank creates the dp and tp groups, in the same order. Makes this
    rank's card current."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: initialize_multihost, torchrun, or "
                           "the command lines' own worker start")
    world, rank = dist.get_world_size(), dist.get_rank()
    if devices is None:
        count = torch.cuda.device_count()
        devices = [f"cuda:{r % count}" for r in range(world)]
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    if dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks; the process group has {world}")
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    dp_group = tp_group = None
    if tp > 1:
        grid = np.arange(n).reshape(dp, tp)
        for j in range(tp):
            g = dist.new_group(grid[:, j].tolist())
            if rank % tp == j:
                dp_group = g
        for i in range(dp):
            g = dist.new_group(grid[i].tolist())
            if rank // tp == i:
                tp_group = g
    return Mesh(dp, tp, rank, devices, dp_group, tp_group)


def mesh_size(dp, tp, n):
    """The device count of the mesh that --dp/--tp resolve to over `n`
    visible devices, with auto_mesh's checks."""
    tp = max(tp, 1)
    if tp > n:
        raise ValueError(f"--tp {tp} exceeds the {n} visible devices")
    if dp <= 0:
        dp = max(n // tp, 1)
    if dp * tp > n:
        raise ValueError(f"--dp {dp} x --tp {tp} exceeds the {n} visible devices")
    return dp * tp


def auto_mesh(dp=0, tp=1, devices=None):
    """Mesh from the command line's --dp/--tp flags, as JAX's auto_mesh
    resolves them: with no request (dp=0, tp=1) every visible device is a
    data-parallel rank (the reference wraps every model in DataParallel,
    main.py:241-248). `devices`: the visible devices (default: every card).
    Returns None when the mesh would be one device, and then callers take
    today's one-device path with no process group."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    n = mesh_size(dp, tp, len(devices))
    if n == 1:
        return None
    return make_mesh(dp=n // max(tp, 1), tp=max(tp, 1), devices=devices[:n])


def _batch_quantum(mesh):
    """Rows divide over 'dp'; one rank a process, so that is the quantum
    (JAX: the lcm of dp and the process count)."""
    return mesh.dp


def round_up_batch(batch_size, mesh):
    """Smallest multiple of the batch quantum >= batch_size (eval
    micro-batches divide over the ranks; the extra rows are weight-0
    padding windows, so metrics are unchanged)."""
    if mesh is None:
        return batch_size
    q = _batch_quantum(mesh)
    return -(-batch_size // q) * q


def batch_rows(n, mesh):
    """This rank's contiguous rows of a global batch of n rows, as a slice
    (the rows JAX's batch sharding puts on the rank's device): those of its
    dp index, the same on every rank of a tp group."""
    per = n // mesh.dp
    return slice(mesh.dp_index * per, (mesh.dp_index + 1) * per)


def step_noise_rows(x, mesh):
    """This rank's rows of a DDIM step-noise stack (K, batch, ...): the
    step axis leads, so the batch split applies to axis 1."""
    return x[:, batch_rows(x.shape[1], mesh)]


def rank_noise(d3dp, bs, generator, mesh, noise=None):
    """This rank's rows of a micro-batch's sampling noise (img0, step
    noises): of `noise`, the global micro-batch's, where given, else of the
    draws `D3DP.sample_noise` makes for it from `generator` (seeded alike
    on every rank, so every rank draws the same)."""
    img0, step_noises = d3dp.sample_noise(bs, generator) if noise is None else noise
    return img0[batch_rows(bs, mesh)], step_noise_rows(step_noises, mesh)


def put_global(x, mesh):
    """This rank's row slice of a host-global batch, as a tensor on its
    device. Every rank holds the identical global batch (the generators
    are deterministic), as every host does under JAX."""
    x = np.ascontiguousarray(np.asarray(x)[batch_rows(len(x), mesh)])
    return torch.from_numpy(x).to(mesh.device)


def shard_batch_fn(mesh, array_indices=(1, 2), weights_index=3):
    """to_device factory for the training Prefetcher under a mesh: pad the
    batch rows to the batch quantum with zero-weight rows (the weighted
    loss is that of the unpadded batch), then place this rank's rows of the
    array members on its device (`put_global`). The weights stay host
    numpy and global: the train step divides by their sum, and the loop
    reads it for its step count without waiting for the device."""
    q = _batch_quantum(mesh)

    def fn(batch):
        out = list(batch)
        n = out[weights_index].shape[0]
        pad = (-n) % q
        if pad:
            for i in array_indices:
                if out[i] is not None:
                    z = ((0, pad),) + ((0, 0),) * (out[i].ndim - 1)
                    out[i] = np.pad(out[i], z)
            out[weights_index] = np.pad(np.asarray(out[weights_index]), (0, pad))
        for i in array_indices:
            if out[i] is not None:
                out[i] = put_global(out[i], mesh)
        return tuple(out)

    return fn


def process_index():
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def gather_rows(parts, bs, mesh, async_op=False):
    """The global stack (len(parts) * bs, ...) on every rank from this
    rank's rows of consecutive micro-batches of bs rows (parts[b]: its rows
    of micro-batch b): each rank writes its rows into a zero buffer of the
    global shape and the buffer is all-reduced over the dp group (the ranks
    of a tp group hold the same rows). With async_op, (buffer, work
    handle): the buffer holds the sum once the work is waited for."""
    rows = batch_rows(bs, mesh)
    buf = parts[0].new_zeros((len(parts) * bs, *parts[0].shape[1:]))
    for b, part in enumerate(parts):
        buf[b * bs + rows.start:b * bs + rows.stop] = part
    work = dist.all_reduce(buf, group=mesh.dp_group, async_op=async_op)
    return (buf, work) if async_op else buf


# ------------------------------------------------------- the tp parameter split
@dataclass(frozen=True)
class TensorParallel:
    """A split model's place in its tp group (`MixSTE2.tp`)."""

    group: Any
    size: int
    index: int


def _column_parallel(key):
    return ".attn.qkv." in key or ".mlp.fc1." in key or key.startswith("time_mlp.1.")


def _row_parallel(key):
    return ".attn.proj." in key or ".mlp.fc2." in key or key.startswith("time_mlp.3.")


def mixste_param_spec(state_dict):
    """{key: "col" | "row" | None} for a MixSTE2 state_dict, JAX's
    `_leaf_spec` by name: "col" (column-parallel, the output features split:
    JAX's P(None, 'tp') on a kernel, P('tp') on its bias) for the weights
    and biases of qkv, fc1 and the time MLP's first layer; "row"
    (row-parallel, the input features split: P('tp', None)) for the weights
    of the attention out-projection, fc2 and the time MLP's second layer;
    None (replicated) for everything else, their biases included."""
    out = {}
    for key, v in state_dict.items():
        spec = None
        if key.endswith(".weight") and v.dim() == 2:
            spec = "col" if _column_parallel(key) else "row" if _row_parallel(key) else None
        elif key.endswith(".bias") and _column_parallel(key):
            spec = "col"
        out[key] = spec
    return out


def _shard_index(key, n, tp, j):
    """Rank j's indices of the split axis (n entries) of parameter `key`:
    for qkv, its heads' share of each of the q, k and v thirds; else its
    contiguous n / tp."""
    if ".attn.qkv." in key:
        c, per = n // 3, n // 3 // tp
        return torch.cat([torch.arange(p * c + j * per, p * c + (j + 1) * per) for p in range(3)])
    per = n // tp
    return torch.arange(j * per, (j + 1) * per)


def shard_tensor(key, t, spec, tp, j):
    """Rank j's slice of the whole parameter t under `spec` (a copy)."""
    if spec is None:
        return t
    dim = 0 if spec == "col" else 1
    return t.index_select(dim, _shard_index(key, t.shape[dim], tp, j).to(t.device))


def _place(key, whole, part, spec, tp, j):
    """Write rank j's slice `part` into the whole-shaped `whole`."""
    dim = 0 if spec == "col" else 1
    whole.index_copy_(dim, _shard_index(key, whole.shape[dim], tp, j).to(whole.device), part)
    return whole


def _whole_shape(t, spec, tp):
    shape = list(t.shape)
    shape[0 if spec == "col" else 1] *= tp
    return shape


def split_state_dict(state_dict, tp, j):
    """Rank j's state_dict of tp ranks from a whole one (shard_params'
    slices)."""
    spec = mixste_param_spec(state_dict)
    return {k: shard_tensor(k, v, spec[k], tp, j) for k, v in state_dict.items()}


def join_state_dicts(parts):
    """The whole state_dict from the tp ranks' ones, parts[j] rank j's: the
    exact inverse of `split_state_dict`."""
    spec = mixste_param_spec(parts[0])
    tp, out = len(parts), {}
    for k, v in parts[0].items():
        if spec[k] is None:
            out[k] = v
            continue
        whole = v.new_empty(_whole_shape(v, spec[k], tp))
        for j, p in enumerate(parts):
            _place(k, whole, p[k], spec[k], tp, j)
        out[k] = whole
    return out


def gather_tensor(key, t, spec, tp):
    """The whole tensor, on every rank of the tp group `tp` (a
    TensorParallel), from each rank's slice t of parameter `key` (the
    parameter or a moment of it): a zero buffer holding this rank's slice,
    all-reduced over the group; a replicated tensor comes back as it is.
    Every rank calls it in the same order."""
    if spec is None:
        return t
    whole = _place(key, t.new_zeros(_whole_shape(t, spec, tp.size)), t, spec, tp.size,
                   tp.index)
    dist.all_reduce(whole, group=tp.group)
    return whole


def gather_params(model):
    """The whole state_dict of a model that `shard_params` split, on every
    rank of its tp group (the inverse of `shard_params`; a collective over
    the group); an unsplit model's own state_dict."""
    sd = {k: v.detach() for k, v in model.state_dict().items()}
    if model.tp is None:
        return sd
    spec = mixste_param_spec(sd)
    return {k: gather_tensor(k, v, spec[k], model.tp) for k, v in sd.items()}


def shard_params(model, mesh):
    """Split a whole MixSTE2's parameters over the mesh's tp ranks, in
    place: each parameter that `mixste_param_spec` splits keeps its
    Parameter object and holds this rank's slice from then on; the
    attention modules run num_heads / tp heads and the model reads its tp
    group (`MixSTE2.tp`). Build the optimizer and DistributedDataParallel
    afterwards."""
    heads, tp = model.cfg.num_heads, mesh.tp
    if heads % tp:
        raise ValueError(f"--tp {tp} must divide the {heads} attention heads")
    if model.tp is not None:
        raise ValueError("the model's parameters are already split")
    spec = mixste_param_spec(model.state_dict())
    with torch.no_grad():
        for name, p in model.named_parameters():
            if spec[name] is not None:
                p.data = shard_tensor(name, p.data, spec[name], tp, mesh.tp_index).contiguous()
    for blk in (*model.STEblocks, *model.TTEblocks):
        blk.attn.num_heads = heads // tp
        blk.attn.tp_group = blk.mlp.tp_group = mesh.tp_group
    model.tp = TensorParallel(mesh.tp_group, tp, mesh.tp_index)
    return model


def shard_model_params(model, mesh):
    """The command lines' helper (JAX's of the same name): split the model's
    parameters over the mesh's tp ranks; a no-op without a mesh or at tp 1.
    Returns the model."""
    if mesh is None or mesh.tp == 1:
        return model
    return shard_params(model, mesh)

"""Data-parallel mesh over torch.distributed ranks.

Counterpart of d3dp_tpu/parallel/mesh.py:21-104, the data-parallel half.
JAX builds one `Mesh` in one process over every local device and lets XLA
insert the collectives. Here a rank is one process that drives one device,
as DistributedDataParallel expects: the mesh names the ranks' devices and
the process group, each rank holds only its rows of a global batch, and
the callers reduce across ranks with `all_reduce` and `broadcast` only
(gloo takes CUDA tensors for those two, so two ranks can share one card
over gloo). Where a gather is needed, each rank writes its rows into a
zero buffer of the global shape and the buffer is all-reduced.

Not ported here: `mixste_param_spec`, `shard_params` and
`shard_model_params`, the tensor-parallel ('tp') split (`tp` > 1 raises).
`replicate_stray_leaves` has no counterpart: each rank's optimizer state
lives beside its own parameters, so there is nothing to place.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """A ('dp', 'tp') mesh: one rank per device, `devices[r]` rank r's."""

    dp: int
    tp: int
    rank: int
    devices: Tuple[torch.device, ...]

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


def make_mesh(dp=None, tp=1, devices=None):
    """Build a ('dp', 'tp') mesh over the ranks of the running process
    group, `devices` one entry per rank (default: rank r drives card r
    modulo the visible count). dp defaults to len(devices) // tp. Makes
    this rank's card current."""
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
    if tp != 1:
        raise NotImplementedError("--tp (the tensor-parallel split) is not ported yet")
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks; the process group has {world}")
    if devices[rank].type == "cuda":
        torch.cuda.set_device(devices[rank])
    return Mesh(dp, tp, rank, devices)


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
    (the rows JAX's batch sharding puts on the rank's device)."""
    per = n // mesh.dp
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


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
    global shape and the buffer is all-reduced. With async_op, (buffer,
    work handle): the buffer holds the sum once the work is waited for."""
    rows = batch_rows(bs, mesh)
    buf = parts[0].new_zeros((len(parts) * bs, *parts[0].shape[1:]))
    for b, part in enumerate(parts):
        buf[b * bs + rows.start:b * bs + rows.stop] = part
    work = dist.all_reduce(buf, async_op=async_op)
    return (buf, work) if async_op else buf

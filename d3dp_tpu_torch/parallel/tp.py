"""The tensor-parallel collectives of the composed path.

Under `--tp` a rank holds a head-aligned share of each column-parallel
layer (qkv, fc1, the time MLP's first layer) and the matching input
columns of each row-parallel one (the attention's out-projection, fc2, the
time MLP's second layer); `parallel.mesh.shard_params` splits them. A
column-parallel layer reads the replicated activation and writes the
rank's share of its outputs; a row-parallel one writes a partial sum of the
whole output, which the tp group sums. In JAX, XLA inserts these
collectives from the sharding (d3dp_tpu/parallel/mesh.py); here they are
two autograd Functions over the tp group, Megatron's pair:

* `copy_to_tp(x, group)`: the identity forward; backward, the gradient is
  the sum over the ranks of each one's (every rank's column share read x),
  all-reduced in fp32.
* `reduce_from_tp(part, group)`: forward, the sum of the ranks' partials,
  all-reduced in fp32 and returned in fp32; backward, the identity (each
  rank's partial fed the sum whole).

Both are the identity without a group. Only `all_reduce` is used, so two
ranks may share one card over gloo.
"""

import torch
import torch.distributed as dist


def _fp32_copy(t):
    """A fresh contiguous fp32 copy of t: the all-reduce works in place."""
    return t.to(torch.float32, memory_format=torch.contiguous_format, copy=True)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = _fp32_copy(g)
        dist.all_reduce(g32, group=ctx.group)
        return g32.to(g.dtype), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, part, group):
        ctx.dtype = part.dtype
        out = _fp32_copy(part)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def copy_to_tp(x, group):
    """x unchanged; its gradient summed over the tp group (module docstring).
    The identity without a group."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(part, group):
    """The fp32 sum of the ranks' `part`s over the tp group; the gradient
    passes unchanged (module docstring). Without a group, part in fp32."""
    return part.float() if group is None else _ReduceFromTP.apply(part, group)

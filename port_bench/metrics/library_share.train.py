"""The device time of the train cell's window in operations other than the
port's own kernels (every `__global__` function of d3dp_tpu_torch/ops/csrc,
read from the sources), over all device time: cuBLAS, PyTorch's own
kernels, copies and fills."""

from port_bench.harness.common import REPO
from port_bench.harness.kernels import function, port_kernels


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    own = port_kernels(REPO)
    total = other = 0
    for name, a, b in tr.ops:
        total += b - a
        if function(name) not in own:
            other += b - a
    return 100.0 * other / total

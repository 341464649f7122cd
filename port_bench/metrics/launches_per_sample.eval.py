"""Device operations a `D3DP.sample` call runs: the operations between
each call's two marker operations (`spin_kernel`, launched by the harness
before and after each call in a traced run), over the calls. None where a
marker is missing from the trace."""

from port_bench.harness.kernels import function


def read(ctx):
    tr = ctx.trace
    if tr is None:
        return None
    calls, inside, count = 0, False, 0
    for name, _, _ in tr.ops:
        if function(name) == "spin_kernel":
            calls += inside
            inside = not inside
        elif inside:
            count += 1
    if inside or calls != ctx.counts["sample_calls"] or calls == 0:
        return None
    return count / calls

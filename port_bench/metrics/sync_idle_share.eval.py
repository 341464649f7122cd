"""The device's idle time behind the host's waits: 100 x the idle time of
the window's gaps that opened while the host was inside a program span
marked `sync`, over the window (a part of idle_share)."""

from port_bench.harness.program import sync_idle_share


def read(ctx):
    return sync_idle_share(ctx)

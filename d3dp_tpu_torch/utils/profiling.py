"""Profiling: a torch.profiler trace around a block of code.

Counterpart of d3dp_tpu/utils/profiling.py's `trace` (there a jax.profiler
trace). The command line's `--profile DIR` wraps the first training epoch
or the first evaluated action in it.
"""

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile


@contextlib.contextmanager
def trace(logdir, enabled=True):
    """Profile the block (host and, where a card is present, device
    activity) and write a Chrome trace to `logdir/trace.json`, which
    chrome://tracing and Perfetto open."""
    if not enabled:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

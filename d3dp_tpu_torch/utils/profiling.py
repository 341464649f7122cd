"""Profiling: a torch.profiler trace around a block of code, and step
timing.

Counterpart of d3dp_tpu/utils/profiling.py: `trace` (there a jax.profiler
trace; the command line's `--profile DIR` wraps the first training epoch
or the first evaluated action in it) and `StepTimer`, the same rolling
host-clock step statistics.
"""

import contextlib
import os
import time

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


class StepTimer:
    """Rolling per-step wall-clock statistics (p50, mean, steps/s) over the
    last `window` intervals between `tick()` calls, on the host clock
    (a loop on the card synchronises before ticking to time the device)."""

    def __init__(self, window=100):
        self.window = window
        self.times = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            if len(self.times) > self.window:
                self.times.pop(0)
        self._last = now

    def stats(self):
        """{"p50_s", "mean_s", "steps_per_s"}, or {} before two ticks."""
        if not self.times:
            return {}
        ts = sorted(self.times)
        return {"p50_s": ts[len(ts) // 2], "mean_s": sum(ts) / len(ts),
                "steps_per_s": len(ts) / sum(ts)}

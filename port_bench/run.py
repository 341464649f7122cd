"""Run one cell of the benchmark of d3dp_tpu_torch and print its result.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of BENCHMARK.json's
`workloads`; its configuration, traffic mix and limits are files under
port_bench/ named after it (port_bench/README.md). The traffic's `kind`
names the loop, port_bench/loops/<kind>.py. A run makes the weights and
the inputs from --seed, warms up, measures for --seconds, holds what the
window produced against the plain reference (port_bench/reference/), and
prints one JSON line as the last line of its standard output: with
--trace 0 the cell's end-to-end metrics, with --trace 1 its per-layer
metrics, each read by port_bench/metrics/<name>.py from the device trace,
the spans and the counts, and a breakdown of the trace.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the program's kernel and compiler caches at fixed paths inside the
# checkout (the kernels themselves build into d3dp_tpu_torch/_build/)
CACHE = REPO / ".port_bench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "d3dp_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's."""
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Run:
    """What a loop is handed: the cell's files, the seed, the device,
    the spans and the tracer."""

    def __init__(self, torch, workload, seed, trace, device, files, overrides=None):
        from port_bench.harness.trace import Spans, Tracer

        self.torch = torch
        self.workload, self.seed, self.trace = workload, seed, trace
        self.device = device
        self.bench, self.cell, self.config, self.traffic, self.limits = files
        for key, value in (overrides or {}).items():
            getattr(self, key).update(value)
        self.spans = Spans(annotate=bool(trace))
        self.tracer = Tracer(bool(trace) and device.type == "cuda")
        # "start": the interpreter, imports and arguments, before the cell
        self._phase_t = time.perf_counter()
        self.setup_phases = {"start": self._phase_t - T_START}

    def phase(self, name):
        """Close the set-up phase `name` (its seconds since the last one)."""
        now = time.perf_counter()
        self.setup_phases[name] = now - self._phase_t
        self._phase_t = now

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def marker(self):
        """A device operation of its own name (`spin_kernel`) that the
        traced run's readers split the trace at; nothing outside a trace."""
        if self.tracer.enabled:
            self.torch.cuda._sleep(0)

    def weights(self):
        from port_bench.harness.common import make_weights

        return make_weights(self.torch, self.config["model"], self.seed, self.device)


def judge(readings, limits):
    """[(name, reading, limit, ok)] of every limited reading."""
    return [(k, readings[k], lim, readings[k] <= lim) for k, lim in limits["limits"].items()]


def open_cell(workload, seed, trace, device=None, overrides=None, files=None):
    """(run, loop) of one cell, the loop not yet set up. `device` None
    means the card, required; the tests pass "cpu" with small
    `overrides` ({"config" or "traffic": entries replaced})."""
    import torch

    from port_bench.harness import common

    files = files or common.cell_files(workload)
    cell = files[1]
    if device is None:
        need = cell["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            raise SystemExit(f"the cell needs {need} CUDA device(s); torch sees "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = "cuda"
    run = Run(torch, workload, seed, trace, torch.device(device), files, overrides)
    if run.device.type == "cuda":
        from d3dp_tpu_torch.device import disable_tf32

        disable_tf32()  # as every entry point does on the card
    loop = load_module(common.BENCH_DIR / "loops" / f"{run.traffic['kind']}.py",
                       f"port_bench_loop_{run.traffic['kind']}").Loop(run)
    return run, loop


def run_cell(workload, seed, seconds, trace, device=None, overrides=None, files=None,
             t_start=None):
    """One run; returns the result line's object."""
    from port_bench.harness import common

    run, loop = open_cell(workload, seed, trace, device, overrides, files)
    torch, dev, bench, cell = run.torch, run.device, run.bench, run.cell
    loop.setup()
    run.tracer.warm_up(torch)
    run.sync()
    run.spans.spans.clear()
    run.phase("tracer")
    setup_s = time.perf_counter() - (T_START if t_start is None else t_start)
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in run.setup_phases.items())
          + f" total {setup_s:.3f} (from the process's start)", file=sys.stderr)

    end_to_end = loop.window(seconds)
    end_to_end["setup_s"] = setup_s
    device_desc = common.device_info(torch, dev, cell["chips"])
    counts = loop.counts()
    loop.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = loop.readings()
    verdicts = judge(readings, run.limits)
    correct = loop.failed == 0 and all(ok for *_, ok in verdicts)

    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    tdata = run.tracer.data
    for m in common.metrics_of(bench, workload, section):
        if trace:
            reader = load_module(common.BENCH_DIR / "metrics" / f"{m['name']}.py",
                                 f"port_bench_metric_{m['name']}")
            value = reader.read(Context(run, counts, tdata, loop.window_s))
        else:
            value = end_to_end[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": loop.attempted, "failed": loop.failed,
           "metrics": metrics, "device": device_desc}
    if trace and tdata is not None:
        out["device"].update(busy_s=tdata.busy_ns() / 1e9, window_s=tdata.window_s)
        out["breakdown"] = tdata.breakdown()
    # a reading that is not a number (nothing checked, a non-finite output)
    # fails its limit above and is printed as null: the line stays JSON
    out["checks"] = {k: {"value": v if math.isfinite(v) else None, "limit": lim}
                     for k, v, lim, _ in verdicts}
    return out


class Context:
    """What a per-layer reader reads: the run (cell, configuration,
    traffic), the loop's counts and spans, the trace (None without one),
    and the measured window's seconds."""

    def __init__(self, run, counts, trace, window_s):
        self.run, self.counts, self.trace, self.window_s = run, counts, trace, window_s
        self.config, self.traffic = run.config, run.traffic
        self.dtype = run.config["model"]["dtype"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out = run_cell(args.workload, args.seed, args.seconds, args.trace)
    found = forbidden_modules()
    if found:
        print(f"refusing to report: modules {found} are loaded", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Read the numbers that decide `correct`, for setting a cell's limits.

    python3 port_bench/calibrate.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds 6] [--controls 3] [--out calibrate_<cell>.jsonl]

For each seed, in one process: a run of the cell's timed path over a short
window, and its readings against the plain reference (the lower end of a
limit). For the first --controls seeds also the control's readings, the
reference computed in the precision below the configuration's
(`control` in the configuration's file: "tf32" for float32, "fp8" for
bfloat16) in the program's place, and in a train cell the planted
half-batch fault's (the upper end). One JSON line a seed, printed and
appended to --out. Needs the card; the benchmark's own runs never run
this.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from port_bench.run import open_cell  # noqa: E402


def calibrate(workload, seeds, seconds, controls, device=None, overrides=None, files=None,
              out=None):
    records = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        run, loop = open_cell(workload, seed, 0, device, overrides, files)
        loop.setup()
        loop.window(seconds)
        loop.release()
        if run.device.type == "cuda":
            run.torch.cuda.empty_cache()
        rec = {"seed": seed, "program": loop.readings(), "failed": loop.failed}
        if i < controls:
            rec["control"] = loop.readings(control=run.config["control"])
            if run.traffic["kind"] == "train":
                rec["half_batch"] = loop.readings(fault="half_batch")
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        if out:
            with open(out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        records.append(rec)
        del run, loop
        gc.collect()
    return records


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    calibrate(args.workload, args.seeds, args.seconds, args.controls, out=args.out)


if __name__ == "__main__":
    main()

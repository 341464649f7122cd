"""Shared pieces of the benchmark's tests: the repository on the path and a
cell cut to a size the CPU runs in seconds."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

CELLS = ("h36m_eval_fp32", "h36m_eval_bf16", "h36m_train_fp32")


def tiny_overrides(files, wide=False):
    """The cell's files at a small size: depth 2, 27 frames, a few short
    takes, width 64; `wide`: the published width (512) with 2 hypotheses
    and one checked micro-batch, where a bfloat16 control's error needs
    the width to show."""
    _, _, config, traffic, _ = files
    model = dict(config["model"], embed_dim=512 if wide else 64, depth=2, num_frames=27)
    tr = dict(traffic)
    if tr["kind"] == "eval":
        tr.update(lengths=[60, 35, 100, 81], actions=2)
        if wide:
            tr.update(num_proposals=2, check_microbatches=1)
    else:
        tr.update(lengths=[200, 150, 300, 260, 90])
    return {"config": {"model": model}, "traffic": tr}


@pytest.fixture
def small_cell():
    """cell name -> (files, overrides) at the small size."""
    from port_bench.harness import common

    def make(cell, wide=False):
        files = common.cell_files(cell)
        return files, tiny_overrides(files, wide)

    return make

"""The harness end to end at a small size on the CPU: a run of each cell
is correct; the control, computed in the precision below the
configuration's in the program's place, is not; and a run whose timed path
is broken underneath comes out not correct, for each fault a cell can
have (one chip: no exchange between chips to leave out)."""

import json

import pytest
import torch

from port_bench import run as R
from port_bench.calibrate import calibrate
from port_bench.harness import common

from conftest import CELLS


def test_cpu_run_is_correct_and_reports_the_cells_metrics(small_cell):
    for cell in CELLS:
        files, over = small_cell(cell)
        out = R.run_cell(cell, 2 ** 31 + 11, 4, 0, device="cpu", overrides=over, files=files)
        assert out["correct"], out["checks"]
        assert out["attempted"] > 0 and out["failed"] == 0
        want = {m["name"] for m in common.metrics_of(files[0], cell, "end_to_end")}
        assert set(out["metrics"]) == want
        assert list(out)[-1] == "checks"
        assert set(out["checks"]) == set(files[4]["limits"])
        json.dumps(out)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(small_cell, cell):
    """The reference in the configuration's control precision (TF32 for
    float32, fp8 for bfloat16) reads past a limit on two seeds, the
    program within them; bfloat16 at the published width."""
    files, over = small_cell(cell, wide=cell == "h36m_eval_bf16")
    limits = files[4]["limits"]
    for rec in calibrate(cell, [5, 2 ** 31 + 3], 4, 2, device="cpu", overrides=over,
                         files=files):
        assert all(rec["program"][k] <= v for k, v in limits.items()), rec
        assert any(rec["control"][k] > v for k, v in limits.items()), rec


def _answer_altered(monkeypatch):
    from d3dp_tpu_torch.diffusion import D3DP

    sample = D3DP.sample

    def altered(self, *args, **kwargs):
        out = sample(self, *args, **kwargs).clone()
        out[0, -1, 0, 5, 3, 1] += 0.5  # one coordinate of one answer, half a metre
        return out

    monkeypatch.setattr(D3DP, "sample", altered)


def _eval_half_batch(monkeypatch):
    from d3dp_tpu_torch.eval import Evaluator

    score = Evaluator._score

    def half(self, preds, x2d, x3d, traj, cam, weights, total=None):
        w = weights.clone()
        w[w.shape[0] // 2:] = 0  # the mean over the first half of the windows
        return score(self, preds, x2d, x3d, traj, cam, w, total)

    monkeypatch.setattr(Evaluator, "_score", half)


def _state_unchanged(monkeypatch):
    from d3dp_tpu_torch.train import state

    make = state.make_optimizer

    def frozen(params, lr, weight_decay=0.1):
        opt = make(params, lr, weight_decay)
        opt.step = lambda closure=None: None  # the step leaves the parameters as they were
        return opt

    monkeypatch.setattr(state, "make_optimizer", frozen)


def _train_half_batch(monkeypatch):
    from d3dp_tpu_torch.train import state

    loss = state.weighted_mpjpe

    def half(pred, target, weights, total=None):
        w = weights.clone()
        w[w.shape[0] // 2:] = 0
        return loss(pred, target, w, total)

    monkeypatch.setattr(state, "weighted_mpjpe", half)


FAULTS = [("h36m_eval_fp32", _answer_altered), ("h36m_eval_bf16", _answer_altered),
          ("h36m_eval_fp32", _eval_half_batch), ("h36m_eval_bf16", _eval_half_batch),
          ("h36m_train_fp32", _state_unchanged), ("h36m_train_fp32", _train_half_batch)]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_broken_timed_path_is_not_correct(small_cell, monkeypatch, cell, fault):
    files, over = small_cell(cell)
    fault(monkeypatch)
    out = R.run_cell(cell, 2 ** 31 + 29, 4, 0, device="cpu", overrides=over, files=files)
    assert not out["correct"], out["checks"]


def test_result_line_and_checks_on_stderr(small_cell, monkeypatch, capsys):
    """main() prints the checks as the last lines of stderr and the result
    as the last line of stdout; a loaded JAX module refuses the result."""
    files, over = small_cell("h36m_eval_fp32")
    real = R.run_cell
    monkeypatch.setattr(R, "run_cell", lambda *a, **k: real(*a, device="cpu", overrides=over,
                                                               files=files))
    assert R.main(["--workload", "h36m_eval_fp32", "--seed", "7", "--seconds", "2"]) == 0
    cap = capsys.readouterr()
    line = json.loads(cap.out.strip().splitlines()[-1])
    assert line["correct"] and "eval_hypframes_per_s" in line["metrics"]
    assert cap.err.strip().splitlines()[-1].startswith("check score_gap_mm")
    monkeypatch.setitem(__import__("sys").modules, "jax", object())
    assert R.main(["--workload", "h36m_eval_fp32", "--seed", "7", "--seconds", "2"]) != 0
    assert capsys.readouterr().out.strip() == ""


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_own_size_on_the_card(cell):
    """On the card, at the published widths: three seeds of the program
    within the limits, the control past one of them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    limits = common.cell_files(cell)[4]["limits"]
    for rec in calibrate(cell, [101, 2 ** 31 + 7, 4_000_000_003], 6, 3):
        assert all(rec["program"][k] <= v for k, v in limits.items()), rec
        assert any(rec["control"][k] > v for k, v in limits.items()), rec

"""`--ckpt-format orbax` in the port: the pickle format's payload as a
torch.distributed.checkpoint (DCP) directory, saved asynchronously.

The command line (tests/test_ckpt_format.py:32's run, in process): a
two-epoch orbax run writes epoch_N.orbax directories and trains as the
pickle run does (equal training log lines but for the elapsed time);
`-r auto` finds epoch_2.orbax and resumes to the same third epoch as a
pickle resume; `--evaluate epoch_3.orbax` evaluates. The library
(tests/test_ckpt_format.py:68): the payload, RandomState included, round
trips bit for bit against the pickle's; an asynchronous save is complete
once waited for, a second save waits for the first, and `latest_checkpoint`
finds the directories.
"""

import os
import re

import numpy as np
import pytest
import torch

from d3dp_tpu_torch.cli import main_h36m as tmain
from d3dp_tpu_torch.eval import MODES
from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig
from d3dp_tpu_torch.train import checkpoint_io as ckio
from d3dp_tpu_torch.train.state import make_optimizer

torch.set_num_threads(1)

BASE = ["-d", "synthetic", "--nolog", "-f", "27", "-cs", "64", "-dep", "2", "-s", "27",
        "--synthetic-frames", "150", "--platform", "cpu", "--seed", "1", "-b", "108", "-cf", "1",
        "--eval-batch-size", "4"]


def run_cli(directory, extra):
    """main_h36m in process; its training log lines without the elapsed
    time."""
    out = tmain.main(BASE + ["-c", str(directory)] + extra)
    log = directory / "training_log.txt"
    lines = log.read_text().splitlines() if log.exists() else []
    return out, [re.sub(r"time [\d.]+ ", "", line) for line in lines]


def test_orbax_cli_train_resume_evaluate(tmp_path):
    orbax, pickle_dir = tmp_path / "orbax", tmp_path / "pickle"
    _, log_o = run_cli(orbax, ["-e", "2", "--ckpt-format", "orbax"])
    assert (orbax / "epoch_2.orbax").is_dir() and (orbax / "epoch_2.orbax" / ".metadata").exists()
    assert not (orbax / "epoch_2.ckpt").exists() and not (orbax / "epoch_2.orbax.tmp").exists()
    _, log_p = run_cli(pickle_dir, ["-e", "2"])
    assert log_o == log_p and sum(line.startswith("[") for line in log_o) == 2

    # resume: the orbax directory's {epoch, lr, optimizer, generator RNG}
    # continue as the pickle's do, to the same third epoch
    assert ckio.latest_checkpoint(str(orbax)).endswith("epoch_2.orbax")
    _, log_r = run_cli(orbax, ["-e", "3", "-r", "auto", "--ckpt-format", "orbax"])
    _, log_rp = run_cli(pickle_dir, ["-e", "3", "-r", "auto"])
    assert log_r == log_rp and any(line.startswith("[3] ") for line in log_r)
    assert (orbax / "epoch_3.orbax").is_dir()

    results, _ = run_cli(orbax, ["--evaluate", "epoch_3.orbax", "-num_proposals", "2",
                                 "-sampling_timesteps", "2"])
    for r in results.values():
        p1 = r.averages_mm()
        assert all(np.isfinite(p1[m]).all() for m in MODES)


def _same(a, b):
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.random.RandomState):
        return all(np.array_equal(x, y) for x, y in zip(a.get_state(), b.get_state()))
    return a == b


@pytest.fixture
def trained(rng):
    """A small MixSTE2 and its AdamW after one step (moments non-zero)."""
    model = MixSTE2(MixSTEConfig(num_frames=9, embed_dim=64, depth=1, num_heads=2), device="cpu")
    opt = make_optimizer(model.parameters(), 1e-3)
    for p in model.parameters():
        p.grad = torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
    opt.step()
    return model, opt


def test_orbax_payload_roundtrip(tmp_path, trained):
    """The DCP directory's payload equals the pickle's bit for bit, the
    RandomState, epoch, lr and min_loss included; load_any reads it."""
    model, opt = trained
    rs = np.random.RandomState(3)
    rs.rand(11)
    kw = dict(epoch=7, lr=1.5e-4, model=model, optimizer=opt, generator_random_state=rs,
              min_loss=42.0)
    d = str(tmp_path / "ck.orbax")
    ckio.save_checkpoint_any(d, "orbax", wait=False, **kw)
    ckio.save_checkpoint_any(str(tmp_path / "ck.ckpt"), "pickle", wait=False, **kw)
    got = ckio.load_checkpoint_orbax(d)  # waits for the pending save
    want = torch.load(tmp_path / "ck.ckpt", weights_only=False)
    assert _same(got, want)
    assert got["epoch"] == 7 and got["lr"] == 1.5e-4 and got["min_loss"] == 42.0
    assert _same(ckio.load_any(d), ckio.load_any(str(tmp_path / "ck.ckpt")))


def test_async_saves_complete_one_at_a_time(tmp_path, trained, monkeypatch):
    """A second save to the same directory waits for the first; each is
    complete once `wait_for_checkpoints` returns, with no `.tmp` left; the
    latest epoch directory and then best_epoch.orbax are found."""
    model, opt = trained
    events = []
    finish = ckio._finish

    def traced(write, tmp, directory):
        events.append(("start", os.path.basename(directory)))
        finish(write, tmp, directory)
        events.append(("done", os.path.basename(directory)))
    monkeypatch.setattr(ckio, "_finish", traced)
    for epoch in (1, 2):
        ckio.save_checkpoint_orbax(str(tmp_path / "best_epoch.orbax"), epoch=epoch, lr=1e-3,
                                   model=model, wait=False)
    ckio.wait_for_checkpoints()
    assert events == [("start", "best_epoch.orbax"), ("done", "best_epoch.orbax")] * 2
    assert ckio.load_any(str(tmp_path / "best_epoch.orbax"))["epoch"] == 2
    assert sorted(os.listdir(tmp_path)) == ["best_epoch.orbax"]
    assert ckio.latest_checkpoint(str(tmp_path)).endswith("best_epoch.orbax")
    for n in (3, 12):
        ckio.save_checkpoint_orbax(str(tmp_path / f"epoch_{n}.orbax"), epoch=n, lr=1e-3,
                                   model=model, wait=True)
    assert ckio.latest_checkpoint(str(tmp_path)).endswith("epoch_12.orbax")


def test_interrupted_replacement_keeps_the_old_checkpoint(tmp_path, trained, monkeypatch):
    """A save of best_epoch.orbax that stops after the old directory was
    moved aside (the second rename fails) leaves the old checkpoint whole at
    best_epoch.orbax.old, where load_any and latest_checkpoint find it under
    its name; the next save puts the new one in place and removes it."""
    model, _ = trained
    best = str(tmp_path / "best_epoch.orbax")
    ckio.save_checkpoint_orbax(best, epoch=1, lr=1e-3, model=model, wait=True)
    replace = os.replace

    def crash_on_the_tmp(src, dst):
        if src.endswith(".tmp"):
            raise OSError("interrupted")
        replace(src, dst)
    monkeypatch.setattr(ckio.os, "replace", crash_on_the_tmp)
    with pytest.raises(OSError, match="interrupted"):
        ckio.save_checkpoint_orbax(best, epoch=2, lr=1e-3, model=model, wait=True)
    monkeypatch.setattr(ckio.os, "replace", replace)
    assert not os.path.exists(best) and os.path.isdir(best + ".old")
    assert ckio.latest_checkpoint(str(tmp_path)) == best
    assert ckio.load_any(best)["epoch"] == 1
    ckio.save_checkpoint_orbax(best, epoch=3, lr=1e-3, model=model, wait=True)
    assert ckio.load_any(best)["epoch"] == 3
    assert os.listdir(tmp_path) == ["best_epoch.orbax"]

"""The readers of the program's own spans and counters
(port_bench/harness/program.py and the metrics that use it) on a synthetic
trace and synthetic recorder contents with known answers, and with nothing
recorded."""

import pytest
import torch

from port_bench.harness import common, program
from port_bench.harness.trace import TraceData
from port_bench.run import Context, load_module

METRICS = common.BENCH_DIR / "metrics"
EVAL = ("ddim_step_ms.eval", "feed_ms.eval", "host_syncs_per_microbatch.eval",
        "sync_idle_share.eval")
TRAIN = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
         "host_syncs_per_step.train", "sync_idle_share.train", "prefetch_starved_share.train")


def reader(name):
    return load_module(METRICS / f"{name}.py", f"test_program_reader_{name}")


class _Run:
    device = torch.device("cuda")


def _ctx(cell, trace):
    files = common.cell_files(cell)
    run = _Run()
    run.config, run.traffic = files[2], files[3]
    return Context(run, {}, trace, 1.0)


def _span(i, name, a, b, parent=None, sync=False, device_ms=None):
    return {"id": i, "name": name, "parent": parent, "thread": 1, "unit": [0], "start_ns": a,
            "end_ns": b, "sync": sync, "device_ms": device_ms}


@pytest.fixture
def recorder(monkeypatch):
    """Sets what the program's recorder returns: (spans, {name: [(t, n)]})."""
    from d3dp_tpu_torch.utils import profiling

    def put(spans, counts):
        def counters(a=None, b=None):
            out = {}
            for k, evs in counts.items():
                n = sum(v for t, v in evs if (a is None or t >= a) and (b is None or t < b))
                if n:
                    out[k] = n
            return out

        monkeypatch.setattr(profiling, "spans", lambda: sorted(spans, key=lambda s: s["start_ns"]))
        monkeypatch.setattr(profiling, "counters", counters)

    return put


# one eval window, 0-1000 ns; spans and device operations:
#   microbatch 0   [100, 600): feed [100, 200) sync, sample [200, 500) with two
#                  steps of device 3.0 and 5.0 ms, score [500, 600)
#   microbatch 1   [600, 990): feed [600, 650) sync, sample [650, 990)
#   a span before the window, which the readers leave out
# device operations [0, 120), [150, 260), [300, 520), [700, 1000): gaps
# [120, 150) inside feed, [260, 300) inside a DDIM step, [520, 700) opening
# in score
EVAL_SPANS = [
    _span(0, "eval.microbatch", 100, 600),
    _span(1, "eval.feed", 100, 200, 0, sync=True),
    _span(2, "sample", 200, 500, 0, device_ms=9.0),
    _span(3, "sample.step", 200, 350, 2, device_ms=3.0),
    _span(4, "sample.step", 350, 500, 2, device_ms=5.0),
    _span(5, "eval.score", 500, 600, 0, device_ms=1.0),
    _span(6, "eval.microbatch", 600, 990),
    _span(7, "eval.feed", 600, 650, 6, sync=True),
    _span(8, "sample", 650, 990, 6, device_ms=9.0),
    _span(9, "eval.feed", -500, -400, sync=True),
]
EVAL_OPS = [("k", 0, 120), ("k", 150, 260), ("k", 300, 520), ("k", 700, 1000)]


def test_gaps_by_the_innermost_program_span():
    trace = TraceData(ops=EVAL_OPS, window_ns=(0, 1000))
    spans = [s for s in EVAL_SPANS if s["start_ns"] >= 0]
    assert program.idle_by_span(trace, spans) == {"eval.feed": 30, "sample.step": 40,
                                                  "eval.score": 180}
    # a gap outside every span
    late = TraceData(ops=EVAL_OPS[:3] + [("k", 650, 700)], window_ns=(0, 1000))
    assert program.idle_by_span(late, spans[:6]) == {"eval.feed": 30, "sample.step": 40,
                                                     "eval.score": 130, None: 300}


def test_eval_readers(recorder):
    recorder(EVAL_SPANS, {"host_syncs": [(150, 6), (300, 10), (620, 6), (-450, 6)]})
    ctx = _ctx("h36m_eval_fp32", TraceData(ops=EVAL_OPS, window_ns=(0, 1000)))
    assert reader("ddim_step_ms.eval").read(ctx) == pytest.approx(4.0)
    assert reader("feed_ms.eval").read(ctx) == pytest.approx(75e-6)
    assert reader("host_syncs_per_microbatch.eval").read(ctx) == pytest.approx(11.0)
    # 30 ns of idle inside a sync span (the feed), of a 1,000 ns window
    assert reader("sync_idle_share.eval").read(ctx) == pytest.approx(3.0)


TRAIN_SPANS = [
    _span(0, "train.step", 0, 400, device_ms=20.0),
    _span(1, "train.feed", 0, 100, 0, sync=True),
    _span(2, "train.forward", 100, 200, 0, device_ms=5.0),
    _span(3, "train.backward", 200, 300, 0, device_ms=10.0),
    _span(4, "train.optimizer", 300, 400, 0, device_ms=1.0),
    _span(5, "train.step", 500, 900, device_ms=22.0),
    _span(6, "train.feed", 500, 600, 5, sync=True),
    _span(7, "train.forward", 600, 700, 5, device_ms=7.0),
    _span(8, "train.backward", 700, 800, 5, device_ms=12.0),
    _span(9, "train.optimizer", 800, 900, 5, device_ms=3.0),
    _span(10, "prefetch.wait", 420, 480),
]


def test_train_readers(recorder):
    recorder(TRAIN_SPANS, {"host_syncs": [(50, 3), (550, 3)],
                           "prefetch.gets": [(430, 1), (1500, 1)],
                           "prefetch.starved": [(430, 1)]})
    ops = [("k", 50, 420), ("k", 470, 520), ("k", 560, 1000)]
    ctx = _ctx("h36m_train_fp32", TraceData(ops=ops, window_ns=(0, 1000)))
    assert reader("forward_ms.train").read(ctx) == pytest.approx(6.0)
    assert reader("backward_ms.train").read(ctx) == pytest.approx(11.0)
    assert reader("optimizer_ms.train").read(ctx) == pytest.approx(2.0)
    assert reader("host_syncs_per_step.train").read(ctx) == pytest.approx(3.0)
    # gaps [0, 50) and [520, 560) open inside train.feed; [420, 470) in the wait
    assert reader("sync_idle_share.train").read(ctx) == pytest.approx(9.0)
    assert reader("prefetch_starved_share.train").read(ctx) == pytest.approx(100.0)


@pytest.mark.parametrize("name", EVAL + TRAIN)
def test_readers_report_nothing_without_spans(recorder, monkeypatch, name):
    cell = "h36m_train_fp32" if name.endswith(".train") else "h36m_eval_fp32"
    trace = TraceData(ops=EVAL_OPS, window_ns=(0, 1000))
    assert reader(name).read(_ctx(cell, None)) is None  # untraced
    recorder([], {})
    assert reader(name).read(_ctx(cell, trace)) is None  # nothing recorded
    # a program whose recorder lacks the read-out
    from d3dp_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert reader(name).read(_ctx(cell, trace)) is None


def test_device_times_missing_on_the_cpu(recorder):
    recorder([dict(s, device_ms=None) for s in TRAIN_SPANS], {})
    ctx = _ctx("h36m_train_fp32", TraceData(ops=[("k", 0, 10)], window_ns=(0, 1000)))
    assert reader("forward_ms.train").read(ctx) is None
    assert reader("host_syncs_per_step.train").read(ctx) == 0.0
    assert reader("prefetch_starved_share.train").read(ctx) is None

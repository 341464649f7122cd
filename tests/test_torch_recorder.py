"""The program's spans and counters (`utils/profiling.py`): nothing is
recorded outside a profiler; inside one, the span tree of
`Evaluator.evaluate`, the train step's phases, the Prefetcher's counters,
the counted host syncs, each span against its own `record_function` event,
and `trace()`'s `program.json`. The card-only tests hold `host_syncs` to
torch's own sync detection and the recorder's clock to the device trace's.

This file imports no JAX, so the card runs it:
`python3 -m pytest tests/test_torch_recorder.py -q --noconftest -m gpu`.
"""

import json
import threading
import time
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from d3dp_tpu_torch.data.generators import UnchunkedGenerator
from d3dp_tpu_torch.data.prefetch import Prefetcher
from d3dp_tpu_torch.data.synthetic import make_dataset
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.eval import Evaluator
from d3dp_tpu_torch.models import MixSTEConfig
from d3dp_tpu_torch.train.state import make_optimizer, make_train_step
from d3dp_tpu_torch.utils import profiling

KL, KR = [4, 5, 6, 11, 12, 13], [1, 2, 3, 14, 15, 16]
F, K, BS = 27, 2, 4
PHASES = ["train.feed", "train.forward", "train.backward", "train.optimizer"]


def _d3dp(device="cpu", **model):
    cfg = {"num_frames": F, "embed_dim": 64, "depth": 2, **model}
    return D3DP(D3DPConfig(model=MixSTEConfig(**cfg), sampling_timesteps=K, num_proposals=2),
                device=device, seed=0)


def _evaluate(d3dp, lengths=(5 * F, 3 * F), rf=F):
    """One evaluate call: windows of `rf` frames, BS a micro-batch (5 and 3
    windows: three micro-batches at the defaults)."""
    ev = Evaluator(d3dp, receptive_field=rf, batch_size=BS, kps_left=KL, kps_right=KR)
    gen = UnchunkedGenerator(*make_dataset(1, lengths))
    rng = torch.Generator(device=d3dp.device).manual_seed(0)
    return ev.evaluate(gen, rng)


def _train_step(d3dp):
    step = make_train_step(d3dp, make_optimizer(d3dp.model.parameters(), 6e-5))
    rng = np.random.RandomState(0)
    fr = d3dp.cfg.model.num_frames
    x2d = rng.randn(BS, fr, 17, 2).astype(np.float32)
    x3d = rng.randn(BS, fr, 17, 3).astype(np.float32)
    w = np.ones(BS, np.float32)
    gen = torch.Generator(device=d3dp.device).manual_seed(0)
    return lambda: step(x2d, x3d, w, generator=gen)


@pytest.fixture
def recorder():
    profiling.reset()
    yield profiling
    profiling.reset()


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


def test_nothing_recorded_outside_a_profiler(recorder):
    d3dp = _d3dp()
    _evaluate(d3dp).averages_mm()
    _train_step(d3dp)()
    assert recorder.spans() == [] and recorder.counters() == {}


def test_evaluate_span_tree(recorder):
    with profile(activities=[ProfilerActivity.CPU]):
        _evaluate(_d3dp())
    spans = recorder.spans()
    (root,) = [s for s in spans if s["parent"] is None and s["name"] == "eval.evaluate"]
    assert root["unit"] == [0]
    mbs = [s for s in _children(spans, root) if s["name"] == "eval.microbatch"]
    assert [s["unit"] for s in mbs] == [[0, 0], [0, 1], [0, 2]]
    # the prep thread's items are waited for inside the call
    assert {s["name"] for s in _children(spans, root)} == {"eval.microbatch", "prefetch.wait"}
    for mb in mbs:
        kids = _children(spans, mb)
        assert [s["name"] for s in kids] == ["eval.feed", "sample", "eval.score"]
        (sample,) = [s for s in kids if s["name"] == "sample"]
        steps = _children(spans, sample)
        assert [s["name"] for s in steps] == ["sample.step"] * K
        flips = [s for step in steps for s in _children(spans, step)]
        assert [s["name"] for s in flips] == ["flip_pose"] * 2 * K and all(
            s["sync"] for s in flips)
        assert [s["unit"] for s in steps] == [mb["unit"] + [k] for k in range(K)]
        assert all(s["unit"] == mb["unit"] for s in kids)
        assert all(mb["start_ns"] <= s["start_ns"] <= s["end_ns"] <= mb["end_ns"]
                   for s in kids + steps)
    feed = [s for s in spans if s["name"] == "eval.feed"]
    assert all(s["sync"] for s in feed) and not any(s["sync"] for s in mbs)
    assert all(s["device_ms"] is None for s in spans)  # no card: no device time
    assert {s["thread"] for s in spans} == {threading.get_ident()}
    # a micro-batch's six copies and, in each DDIM step, the flip's two
    assert recorder.counters()["host_syncs"] == len(mbs) * (6 + 2 * K)


def test_reads_are_spans_with_their_host_syncs(recorder):
    result = _evaluate(_d3dp())
    with profile(activities=[ProfilerActivity.CPU]):
        result.averages_mm()
        result.averages_mm()
    reads = [s for s in recorder.spans() if s["name"] == "eval.read"]
    assert len(reads) == 2 and all(s["sync"] and s["parent"] is None for s in reads)
    # four modes a micro-batch, read once
    assert recorder.counters() == {"host_syncs": 3 * 4}


def test_train_step_phases_and_host_syncs(recorder):
    step = _train_step(_d3dp(drop_path_rate=0.1))
    step()
    with profile(activities=[ProfilerActivity.CPU]):
        step()
        step()
    spans = recorder.spans()
    roots = [s for s in spans if s["parent"] is None]
    assert [(s["name"], s["unit"]) for s in roots] == [("train.step", [1]), ("train.step", [2])]
    for root in roots:
        kids = _children(spans, root)
        assert [s["name"] for s in kids] == PHASES
        assert all(s["unit"] == root["unit"] for s in kids)
        assert [s["sync"] for s in kids] == [True, False, False, False]
        assert all(a["end_ns"] <= b["start_ns"] for a, b in zip(kids, kids[1:]))
    # x2d, x3d and the weights copied from host memory
    assert recorder.counters() == {"host_syncs": 2 * 3}


def _slow(n, pause):
    for i in range(n):
        time.sleep(pause)
        yield i


@pytest.mark.parametrize("producer_pause,consumer_pause,starved", [
    (0.05, 0.0, (3, 3)),  # the consumer always finds the queue empty
    (0.0, 0.05, (0, 1)),  # the producer keeps the queue full after its start
])
def test_prefetcher_counts_starved_gets(recorder, producer_pause, consumer_pause, starved):
    with profile(activities=[ProfilerActivity.CPU]):
        got = []
        for item in Prefetcher(_slow(3, producer_pause), depth=2):
            got.append(item)
            time.sleep(consumer_pause)
    assert got == [0, 1, 2]
    counts = recorder.counters()
    assert counts["prefetch.gets"] == 3
    assert starved[0] <= counts.get("prefetch.starved", 0) <= starved[1]
    waits = [s for s in recorder.spans() if s["name"] == "prefetch.wait"]
    assert len(waits) == 4  # the three items and the end


# The recorder's clock and the profiler's host events agree to a few
# microseconds: over 9,000 spans on the CPU a span opened 2.7 us or more
# before its event and closed 0.9 us or more after it.
CLOCK_AGREE_NS = 20_000


def test_spans_bracket_their_own_profiler_events(recorder):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _evaluate(_d3dp(), lengths=(5 * F,))
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(profiling.PREFIX):
            events.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    spans = recorder.spans()
    assert sum(map(len, events.values())) == len(spans)
    for name, evs in events.items():
        mine = [s for s in spans if profiling.PREFIX + s["name"] == name]
        for s, (a, b) in zip(mine, sorted(evs)):
            assert a <= b, name
            assert s["start_ns"] <= a + CLOCK_AGREE_NS and b <= s["end_ns"] + CLOCK_AGREE_NS, name


def test_units_parents_and_counter_windows():
    rec = profiling.Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.span("a", unit=7):
            with rec.span("b"):
                rec.count("n", 2)
                with rec.span("c", unit=1):
                    pass
            mid = time.time_ns()
            with pytest.raises(ValueError), rec.span("d", sync=True):
                rec.count("n")
                raise ValueError
            with rec.span("e", unit=2):
                # a span of another thread: its parent is none of this one's
                t = threading.Thread(target=lambda: rec.span("f").__enter__().__exit__())
                t.start()
                t.join(5)
                assert not t.is_alive()
    a, b, c, d, e, f = rec.spans()
    assert [s["parent"] for s in (a, b, c, d, e, f)] == [None, a["id"], b["id"], a["id"],
                                                         a["id"], None]
    assert [s["unit"] for s in (a, b, c, d, e, f)] == [[7], [7], [7, 1], [7], [7, 2], None]
    assert f["thread"] != a["thread"] == e["thread"]
    assert d["sync"] and not a["sync"] and d["end_ns"] >= d["start_ns"] >= mid >= b["end_ns"]
    assert rec.counters() == {"n": 3}
    assert rec.counters(end_ns=mid) == {"n": 2} and rec.counters(start_ns=mid) == {"n": 1}
    rec.reset()
    assert rec.spans() == [] and rec.counters() == {}


def test_trace_writes_program_json(recorder, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]):
        _train_step(_d3dp())()  # recorded before the trace, and dropped by it
    with profiling.trace(str(tmp_path / "prof")):
        _train_step(_d3dp())()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    out = json.loads((tmp_path / "prof" / "program.json").read_text())
    assert [s["name"] for s in out["spans"]] == ["train.step"] + PHASES
    assert out["counters"] == {"host_syncs": 3}


# ------------------------------------------------------------------ the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from d3dp_tpu_torch import disable_tf32

    disable_tf32()
    return torch.device("cuda")


def _sync_warnings(fn):
    """(torch's synchronizing-call warnings while fn runs, the host_syncs
    the program counted), fn run inside a profiler."""
    before = profiling.counters().get("host_syncs", 0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n = sum("called a synchronizing CUDA operation" in str(x.message) for x in w)
    return n, profiling.counters().get("host_syncs", 0) - before


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["evaluate", "train_step"])
def test_host_syncs_match_torchs_sync_detection(recorder, what):
    """At the published width (depth 2, 243 frames): every call that makes
    the host wait is counted, in one micro-batch of `Evaluator.evaluate` (and
    its read) and in one train step."""
    dev = _card()
    d3dp = _d3dp(dev, num_frames=243, embed_dim=512, drop_path_rate=0.1)
    if what == "evaluate":
        def fn():
            _evaluate(d3dp, lengths=(BS * 243,), rf=243).averages_mm()
    else:
        fn = _train_step(d3dp)
    fn()  # warm-up: kernels, the weight cache
    warned, counted = _sync_warnings(fn)
    assert warned == counted > 0


# The sync span ends this long after the kernel it waited for, at most, on
# the card; it measured 0.12-0.13 ms.
CLOCK_SLACK_NS = 2_000_000


@pytest.mark.gpu
def test_sync_span_ends_after_its_kernel_on_the_trace_clock(recorder):
    _card()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):  # the first one warms the profiler up
            with profiling.span("clock", sync=True):
                torch.cuda._sleep(50_000_000)
                torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and "spin_kernel" in e.name()]
    spans = [s for s in recorder.spans() if s["name"] == "clock"]
    assert len(kernels) == len(spans) == 2
    (a, b), s = kernels[1], spans[1]
    assert s["start_ns"] <= a < b <= s["end_ns"] <= b + CLOCK_SLACK_NS

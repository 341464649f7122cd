"""The yardstick: the readers' frozen operation and byte counts against
PERF.md's "Bound ms" column, the readers on synthetic traces, the plain
reference against the port's CPU path, and the harness's imports."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from port_bench.arch import architecture
from port_bench.harness import common
from port_bench.harness.peaks import bound_s
from port_bench.harness.trace import TraceData
from port_bench.run import Context, load_module

from conftest import REPO

METRICS = common.BENCH_DIR / "metrics"


def reader(name):
    return load_module(METRICS / f"{name}.py", f"test_reader_{name}")


def ms(s):
    return round(1e3 * s, 4)


def test_bounds_reproduce_the_kernel_table():
    """PERF.md section 6, "Bound ms": K1 0.3562 / 0.4335, K2 0.3504, K4
    0.0354 in bf16; K1 2.1351 / 2.5986, K2 2.1002, K4 0.0707 / 0.1246 as
    three TF32 passes in fp32; at the eval shapes (40 rows of 243 x 17) and
    the train shapes (4 chunks)."""
    k1, k2, k4 = (reader(n) for n in ("roofline_k1_stage.eval", "roofline_k2_mlp.eval",
                                      "roofline_k4_attn_bwd.train"))
    assert tuple(map(ms, k1.call_bounds_s(40, 243, 17, 512, "bfloat16"))) == (0.3562, 0.4335)
    assert tuple(map(ms, k1.call_bounds_s(40, 243, 17, 512, "float32"))) == (2.1351, 2.5986)
    assert ms(k2.call_bound_s(40, 243, 17, 512, 1024, "bfloat16")) == 0.3504
    assert ms(k2.call_bound_s(40, 243, 17, 512, 1024, "float32")) == 2.1002
    for dt, item, want in (("bfloat16", 2, (0.0354, 0.0354)), ("float32", 4, (0.0707, 0.1246))):
        got = (ms(bound_s(*k4.flops_bytes(4 * 243, 17, 512, item), dt)),
               ms(bound_s(*k4.flops_bytes(4 * 17, 243, 512, item), dt)))
        assert got == want
    assert ms(k4.step_bound_s(4, 243, 17, 512, 8, 8, "float32")) == pytest.approx(
        8 * (0.0707 + 0.1246), abs=1e-3)


def test_forward_operations():
    """59 TFLOP a `sample` at the eval config (40 rows, K = 5) and 3.5 TFLOP
    a training step (3 x the forward of 4 chunks)."""
    m = common.load_json(common.BENCH_DIR / "configs" / "d3dp_h36m_fp32.json")["model"]
    forward_flops = architecture(m).forward_flops
    assert 40 * 5 * forward_flops(m) == pytest.approx(59.3e12, rel=0.01)
    assert 3 * 4 * forward_flops(m) == pytest.approx(3.56e12, rel=0.01)


class _Run:
    device = torch.device("cuda")


def _ctx(cell, counts, trace, window_s=1.0):
    files = common.cell_files(cell)
    run = _Run()
    run.config, run.traffic = files[2], files[3]
    return Context(run, counts, trace, window_s)


def _ops(spec):
    """[(name, start, end)] back to back from [(name, count, ns each)]."""
    out, t = [], 1000
    for name, n, dur in spec:
        for _ in range(n):
            out.append((name, t, t + dur))
            t += dur + 10
    return out


def test_stage_and_mlp_readers_on_a_synthetic_trace():
    calls = 2
    per = calls * 2 * 8 * 5
    ops = _ops([("void ln_qkv_walk_f32_kernel<false, false>(QkvParamsF32)", per, 4_000_000),
                ("void attend_f32_kernel<2>(float const*)", per, 1_000_000),
                ("void proj_ln2_walk_f32_kernel<false>(ProjParamsF32)", per, 2_000_000),
                ("void mlp_block_kernel<float, true, false>(MlpParams<float>)", per, 8_000_000)])
    tr = TraceData(ops=ops, window_ns=(0, ops[-1][2] + 10))
    ctx = _ctx("h36m_eval_fp32", {"sample_calls": calls, "rows": 40}, tr)
    k1 = reader("roofline_k1_stage.eval").read(ctx)
    assert k1 == pytest.approx(100 * (2.1351 + 2.5986) / 2 / 7.0, rel=1e-3)
    assert reader("roofline_k2_mlp.eval").read(ctx) == pytest.approx(100 * 2.1002 / 8, rel=1e-3)
    # a launch lost from the trace: no share read from a partial sum
    lost = TraceData(ops=ops[1:], window_ns=tr.window_ns)
    assert reader("roofline_k1_stage.eval").read(
        _ctx("h36m_eval_fp32", {"sample_calls": calls, "rows": 40}, lost)) is None
    assert reader("roofline_k1_stage.eval").read(
        _ctx("h36m_eval_fp32", {"sample_calls": calls, "rows": 40}, None)) is None


def test_launch_and_idle_readers():
    ops = _ops([("at::cuda::(anonymous namespace)::spin_kernel(long)", 1, 10),
                ("k", 5, 100), ("at::cuda::(anonymous namespace)::spin_kernel(long)", 2, 10),
                ("k", 3, 100), ("at::cuda::(anonymous namespace)::spin_kernel(long)", 1, 10)])
    tr = TraceData(ops=ops, window_ns=(0, 4000))
    ctx = _ctx("h36m_eval_fp32", {"sample_calls": 2}, tr)
    assert reader("launches_per_sample.eval").read(ctx) == 4.0
    busy = sum(b - a for _, a, b in ops)
    assert tr.busy_ns() == busy
    assert reader("idle_share.eval").read(ctx) == pytest.approx(100 * (1 - busy / 4000))
    assert reader("launches_per_sample.eval").read(
        _ctx("h36m_eval_fp32", {"sample_calls": 3}, tr)) is None
    bd = tr.breakdown()
    assert bd["device_ops"][0][0] == "k" and len(bd["idle_gaps"]) <= 10


def test_train_readers_on_a_synthetic_trace():
    steps = 3
    ops = _ops([("void attn_bwd_short_f32_kernel<3>(float const*)", steps * 8, 250_000),
                ("void attn_bwd_query_f32_kernel(float const*)", steps * 8, 600_000),
                ("void attn_bwd_key_f32_kernel(float const*)", steps * 8, 400_000),
                ("ampere_sgemm_128x64_nn", steps * 100, 500_000)])
    tr = TraceData(ops=ops, window_ns=(0, ops[-1][2]))
    ctx = _ctx("h36m_train_fp32", {"steps": steps, "batch": 4}, tr)
    k4 = reader("roofline_k4_attn_bwd.train").read(ctx)
    assert k4 == pytest.approx(100 * 8 * (0.0707 + 0.1246) / (8 * 1.25), rel=2e-3)
    lib = reader("library_share.train").read(ctx)
    own = steps * 8 * 1_250_000
    assert lib == pytest.approx(100 * steps * 100 * 500_000 / (own + steps * 100 * 500_000))


def test_reference_matches_the_ports_cpu_path():
    """MixSTE2's forward and `D3DP.sample` of the port on the CPU against
    the float64 reference at a small size, the same weights and draws."""
    from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
    from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig

    from port_bench.reference import diffusion, model as ref_model

    cfg = common.load_json(common.BENCH_DIR / "configs" / "d3dp_h36m_fp32.json")
    m = dict(cfg["model"], embed_dim=64, depth=2, num_frames=27)
    w = common.make_weights(torch, m, 3, torch.device("cpu"))
    port = MixSTE2(MixSTEConfig(num_frames=27, embed_dim=64, depth=2), device="cpu")
    port.load_state_dict(w)
    ref = ref_model.build(m, w)
    g = torch.Generator().manual_seed(0)
    x2d = torch.randn(3, 27, 17, 2, generator=g)
    x3d = torch.randn(3, 27, 17, 3, generator=g)
    t = torch.tensor([3, 500, 999])
    got = port(x2d, x3d, t)
    with torch.no_grad():
        want = ref(x2d.double(), x3d.double(), t)
    assert float((got.double() - want).abs().max()) < 1e-4

    d3dp = D3DP(D3DPConfig(model=port.cfg, num_proposals=2, sampling_timesteps=3), model=port)
    img0 = torch.randn(3, 2, 27, 17, 3, generator=g)
    steps = torch.randn(3, 3, 2, 27, 17, 3, generator=g)
    flip = x2d.clone()
    flip[..., 0] *= -1
    got = d3dp.sample(x2d, flip, noise_override=(img0, steps))
    want = diffusion.sample(ref, x2d.double(), flip.double(), img0, steps, cfg["diffusion"],
                            cfg["joints_left"], cfg["joints_right"])
    assert got.shape == want.shape
    assert float((got.double() - want).abs().max()) < 5e-4


def _imports(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_jax_and_an_independent_reference():
    """A run imports no module whose top-level name is jax, jaxlib, flax
    or d3dp_tpu; the reference imports nothing of the program."""
    ref = _imports("import json, sys, port_bench.reference.model, port_bench.reference.diffusion,"
                   " port_bench.reference.modes, port_bench.reference.feed,"
                   " port_bench.reference.train, port_bench.reference.precision,"
                   " port_bench.arch.mixste2;"
                   " print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    assert not {"d3dp_tpu_torch", "d3dp_tpu", "jax", "jaxlib", "flax"} & set(ref)
    code = ("import json, sys; sys.path.insert(0, 'port_bench/tests');"
            " from conftest import tiny_overrides; from port_bench import run as R;"
            " from port_bench.harness import common;"
            " out = [R.run_cell(c, 9, 1, 0, device='cpu', overrides=tiny_overrides("
            "common.cell_files(c))) for c in ('h36m_eval_bf16', 'h36m_train_fp32')];"
            " print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))")
    loaded = _imports(code)
    assert "d3dp_tpu_torch" in loaded
    assert not {"d3dp_tpu", "jax", "jaxlib", "flax"} & set(loaded)


def test_a_cell_traffic_and_metric_from_files_alone(tmp_path):
    """A copy of the benchmark gains a traffic mix, a cell and a per-layer
    metric by new files and new entries only, and runs them."""
    shutil.copytree(common.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = common.load_json(REPO / "BENCHMARK.json")
    pb = tmp_path / "port_bench"
    mix = common.load_json(pb / "traffic" / "eval_stream.json")
    mix.update(lengths=[30, 70, 55], num_proposals=3, sampling_timesteps=2)
    (pb / "traffic" / "eval_short.json").write_text(json.dumps(mix))
    (pb / "limits" / "h36m_eval_short.json").write_text(
        (pb / "limits" / "h36m_eval_bf16.json").read_text())
    (pb / "metrics" / "completed_microbatches.eval.py").write_text(
        "def read(ctx):\n    return float(ctx.counts['completed'])\n")
    bench["workloads"].append({"name": "h36m_eval_short", "config": "d3dp_h36m_bf16",
                               "traffic": "eval_short", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "completed_microbatches.eval", "unit": "count",
                               "better": "higher", "source": "program_counter",
                               "layer": "Evaluator", "moves": "eval_hypframes_per_s",
                               "workloads": ["h36m_eval_short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (f"import sys, json; sys.path[:0] = [{str(tmp_path)!r}, {str(REPO)!r},"
            f" {str(REPO / 'port_bench' / 'tests')!r}];"
            " from conftest import tiny_overrides; from port_bench import run as R;"
            " from port_bench.harness import common;"
            " assert common.REPO.as_posix() == " + repr(tmp_path.as_posix()) + ";"
            " f = common.cell_files('h36m_eval_short'); o = tiny_overrides(f);"
            " o['traffic'].update(lengths=[30, 70, 55]);"
            " print(json.dumps(R.run_cell('h36m_eval_short', 4, 1, 1, device='cpu',"
            " overrides=o, files=f)))")
    out = _imports(code)
    assert out["correct"], out["checks"]
    assert out["metrics"]["completed_microbatches.eval"]["value"] >= 1

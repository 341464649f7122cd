"""The architecture a configuration names (port_bench/arch/): MixSTE2's
module reproduces what the harness computed before it named one (the
weights, a step's draws, the operation count, the launch counts and
bounds), and a second architecture, a stand-in registered under a name
of its own, runs an eval and a train cell and is counted with its own
numbers, from new files and new BENCHMARK.json entries alone."""

import copy
import sys
import types

import numpy as np
import pytest
import torch

from port_bench import run as R
from port_bench.arch import architecture, mixste2
from port_bench.harness import common
from port_bench.harness.peaks import PEAK_FLOPS
from port_bench.harness.trace import TraceData
from port_bench.reference.model import MixSTE2, droppath_rates
from port_bench.run import Context, load_module

from conftest import REPO, tiny_overrides

CONFIGS = ("d3dp_h36m_fp32", "d3dp_h36m_bf16")


def _config(name):
    return common.load_json(common.BENCH_DIR / "configs" / f"{name}.json")


# ---------------------------------------------- the harness before arch/
def _parent_make_weights(torch, model_cfg, seed, device):
    """harness/common.py::make_weights as it was before the configuration
    named its architecture: the golden copy."""
    with torch.device("meta"):
        m = MixSTE2(model_cfg["num_frames"], model_cfg["num_joints"], model_cfg["embed_dim"],
                    model_cfg["depth"], model_cfg["num_heads"], model_cfg["mlp_ratio"],
                    model_cfg.get("in_chans", 2))
    linear, norm = set(), set()
    for name, mod in m.named_modules():
        if isinstance(mod, torch.nn.Linear):
            linear.add(f"{name}.weight")
        elif isinstance(mod, torch.nn.LayerNorm):
            norm.add(f"{name}.weight")
    shapes = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    total = sum(int(np.prod(s)) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(common.sub_seed(seed, "weights"))
    flat = torch.randn(2 * total, generator=g, device=device) * 0.02
    out, off = {}, 0
    for k, s in shapes.items():
        n = int(np.prod(s))
        w = flat[off:off + n].view(s).clone()
        if k in linear:
            w += flat[total + off:total + off + n].view(s)
        elif k in norm:
            w += 1.0
        out[k] = w
        off += n
    return out


def _parent_draws(state, device, B, model_cfg, timesteps):
    """reference/train.py::draws as it was: the golden copy."""
    g = torch.Generator(device=device)
    g.set_state(state)
    Fr, J = model_cfg["num_frames"], model_cfg["num_joints"]
    t = torch.randint(0, timesteps, (B,), generator=g, device=device)
    noise = torch.randn((B, Fr, J, 3), generator=g, device=device)
    masks = {}
    for i, rate in enumerate(droppath_rates(model_cfg)):
        rate = float(rate)
        for kind, per in (("ste", Fr), ("tte", J)):
            if rate <= 0.0:
                continue
            keep = 1.0 - rate
            masks[f"{kind}_{i}"] = tuple(
                torch.where(torch.rand(B * per, generator=g, device=device) < keep,
                            1.0 / keep, 0.0) for _ in range(2))
    return t, noise, masks


# ------------------------------------------------------------- MixSTE2
def test_mixste2_is_the_default_and_an_unknown_name_is_refused(small_cell):
    for name in CONFIGS:
        m = _config(name)["model"]
        assert "arch" not in m and architecture(m) is mixste2
    assert architecture({"arch": "mixste2"}) is mixste2
    files, over = small_cell("h36m_eval_fp32")
    bench, cell, config, traffic, limits = files
    for bad in ("nosuch_net", "../run"):
        named = dict(config, model=dict(config["model"], arch=bad))
        with pytest.raises(SystemExit, match=bad.replace(".", r"\.")):
            R.open_cell("h36m_eval_fp32", 1, 0, "cpu", files=(bench, cell, named, traffic, limits))


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 5])
@pytest.mark.parametrize("size", ["tiny", "published_widths"])
def test_make_weights_as_before(seed, size):
    """The same draw, keys in the same order, bit for bit: the tiny
    configuration (width 64) and the published widths (512, 8 heads, MLP
    1024, 243 frames) at depth 2."""
    m = dict(_config("d3dp_h36m_fp32")["model"], depth=2)
    if size == "tiny":
        m.update(embed_dim=64, num_frames=27)
    got = common.make_weights(torch, m, seed, torch.device("cpu"))
    want = _parent_make_weights(torch, m, seed, torch.device("cpu"))
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_shapes_as_before_at_the_published_size(name):
    """Every key, shape and kind make_weights draws from, at depth 8."""
    m = _config(name)["model"]
    with torch.device("meta"):
        ref = MixSTE2(m["num_frames"], m["num_joints"], m["embed_dim"], m["depth"],
                      m["num_heads"], m["mlp_ratio"], m["in_chans"])
    kinds = {f"{n}.weight": type(mod).__name__ for n, mod in ref.named_modules()}
    want = [(k, tuple(v.shape), {"Linear": "linear", "LayerNorm": "norm"}.get(kinds.get(k),
                                                                                 "other"))
            for k, v in ref.state_dict().items()]
    assert mixste2.parameter_shapes(m) == want
    assert sum(kind == "linear" for *_, kind in want) == 4 * 2 * 8 + 4
    assert sum(kind == "norm" for *_, kind in want) == 2 * 2 * 8 + 3


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_of_the_published_configurations(name):
    m = _config(name)["model"]
    assert architecture(m).forward_flops(m) == 294_860_054_528


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 17])
def test_step_draws_as_before(seed):
    m = dict(_config("d3dp_h36m_fp32")["model"], num_frames=27)
    g = torch.Generator().manual_seed(seed)
    torch.rand(5, generator=g)
    state = g.get_state()
    got = mixste2.step_draws(state, torch.device("cpu"), 4, m, 1000)
    want = _parent_draws(state, torch.device("cpu"), 4, m, 1000)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert list(got[2]) == list(want[2]) and len(want[2]) == 2 * (m["depth"] - 1)
    for k in want[2]:
        assert all(torch.equal(a, b) for a, b in zip(got[2][k], want[2][k])), k


def _parent_programs(config, traffic, device, seed):
    """The D3DP of loops/eval.py's and loops/train.py's set-up as they
    were: the golden copies, (eval, train)."""
    from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
    from d3dp_tpu_torch.models import MixSTEConfig

    m, d = config["model"], config["diffusion"]
    mcfg = MixSTEConfig(num_frames=m["num_frames"], num_joints=m["num_joints"],
                        in_chans=m["in_chans"], embed_dim=m["embed_dim"], depth=m["depth"],
                        num_heads=m["num_heads"], mlp_ratio=m["mlp_ratio"],
                        drop_path_rate=m["drop_path_rate"],
                        dtype=getattr(torch, m["dtype"]), fuse_level=m["fuse_level"])
    joints = dict(joints_left=tuple(config["joints_left"]),
                  joints_right=tuple(config["joints_right"]))
    ev = D3DPConfig(model=mcfg, timesteps=d["timesteps"],
                    sampling_timesteps=traffic["sampling_timesteps"],
                    num_proposals=traffic["num_proposals"], scale=d["scale"], eta=d["eta"],
                    flip_tta=d["flip_tta"], unit_scale=d["unit_scale"], **joints)
    tr = D3DPConfig(model=mcfg, timesteps=d["timesteps"], scale=d["scale"],
                    unit_scale=d["unit_scale"], flip_tta=d["flip_tta"], **joints)
    return D3DP(ev, device=device, seed=seed), D3DP(tr, device=device, seed=seed)


@pytest.mark.parametrize("name", CONFIGS)
def test_make_program_as_before(name):
    """The eval and the train loop's D3DP: the same configuration, and the
    same weights drawn from the same seed, as the loops built before."""
    config = _config(name)
    config = dict(config, model=dict(config["model"], embed_dim=64, depth=2, num_frames=27))
    traffic = common.load_json(common.BENCH_DIR / "traffic" / "eval_stream.json")
    dev, seed = torch.device("cpu"), 2 ** 31 - 9
    want_eval, want_train = _parent_programs(config, traffic, dev, seed)
    arch = architecture(config["model"])
    got_eval = common.make_program(arch, config, dev, seed,
                                   sampling_timesteps=traffic["sampling_timesteps"],
                                   num_proposals=traffic["num_proposals"])
    got_train = common.make_program(arch, config, dev, seed)
    for got, want in ((got_eval, want_eval), (got_train, want_train)):
        assert got.cfg == want.cfg
        g, w = got.model.state_dict(), want.model.state_dict()
        assert list(g) == list(w) and all(torch.equal(g[k], w[k]) for k in w)


# ----------------------------------------------------- readers' counts
def reader(name):
    return load_module(common.BENCH_DIR / "metrics" / f"{name}.py", f"test_arch_reader_{name}")


class _Run:
    device = torch.device("cuda")


def _ctx(cell, counts, trace, model=None, window_s=1.0):
    """A traced run's context on the card, the configuration's `model`
    entries replaced by `model`."""
    files = common.cell_files(cell)
    run = _Run()
    run.config = dict(files[2], model=dict(files[2]["model"], **(model or {})))
    run.traffic = files[3]
    return Context(run, counts, trace, window_s)


def _ops(spec):
    """[(name, start, end)] back to back from [(name, count, ns each)]; the
    durations differ from launch to launch, so a sum in another order
    would show."""
    out, t = [], 1000
    for name, n, dur in spec:
        for i in range(n):
            out.append((name, t, t + dur + 37 * (i % 7)))
            t = out[-1][2] + 10
    return out


def _eval_ops(per_name):
    return _ops([("void ln_qkv_walk_f32_kernel<false, false>(QkvParamsF32)", per_name, 4_000_001),
                 ("void attend_f32_kernel<2>(float const*)", per_name, 1_000_003),
                 ("void proj_ln2_walk_f32_kernel<false>(ProjParamsF32)", per_name, 2_000_007),
                 ("void mlp_block_kernel<float, true, false>(MlpParams<float>)", per_name,
                  8_000_009)])


def _seconds(ops, prefix):
    return [(b - a) / 1e9 for name, a, b in ops if prefix in name]


@pytest.mark.parametrize("depth", [2, 8])
def test_block_counts_give_the_depth_forms(depth):
    """K1 and K2: 2 x depth launches of each name a forward and K1's bound
    depth x (spatial + temporal); K4: depth x (launches(J) + launches(F))
    a step and its bound depth x (spatial + temporal): the numbers of the
    readers before `blocks()`, to the last bit."""
    k1, k2, k4 = (reader(n) for n in ("roofline_k1_stage.eval", "roofline_k2_mlp.eval",
                                      "roofline_k4_attn_bwd.train"))
    calls, K, rows = 3, 5, 40
    per_name = calls * 2 * depth * K
    ops = _eval_ops(per_name)
    tr = TraceData(ops=ops, window_ns=(0, ops[-1][2] + 10))
    ctx = _ctx("h36m_eval_fp32", {"sample_calls": calls, "rows": rows}, tr, {"depth": depth})
    sp, tp = k1.call_bounds_s(rows, 243, 17, 512, "float32")
    k1_time = sum(sum(_seconds(ops, p)) for p in k1.LAUNCHES)
    assert k1.read(ctx) == 100.0 * (per_name // 2 * (sp + tp)) / k1_time
    k2_bound = per_name * k2.call_bound_s(rows, 243, 17, 512, 1024, "float32")
    assert k2.read(ctx) == 100.0 * k2_bound / sum(_seconds(ops, "mlp_block_kernel"))
    # one launch fewer or more of a name: no share
    for wrong in (per_name - 1, per_name + 1):
        ops_w = _eval_ops(wrong)
        ctx_w = _ctx("h36m_eval_fp32", {"sample_calls": calls, "rows": rows},
                     TraceData(ops=ops_w, window_ns=(0, ops_w[-1][2] + 10)), {"depth": depth})
        assert k1.read(ctx_w) is None and k2.read(ctx_w) is None

    steps = 3
    want = steps * depth * (k4.launches(17, "float32") + k4.launches(243, "float32"))
    ops = _ops([("void attn_bwd_query_f32_kernel(float const*)", want, 600_001),
                ("ampere_sgemm_128x64_nn", 50, 500_000)])
    ctx = _ctx("h36m_train_fp32", {"steps": steps, "batch": 4},
               TraceData(ops=ops, window_ns=(0, ops[-1][2])), {"depth": depth})
    item = 4
    old_bound = depth * (k4.bound_s(*k4.flops_bytes(4 * 243, 17, 512, item), "float32")
                         + k4.bound_s(*k4.flops_bytes(4 * 17, 243, 512, item), "float32"))
    assert k4.read(ctx) == 100.0 * steps * old_bound / sum(_seconds(ops, "attn_bwd_"))
    ops = ops[1:]
    assert k4.read(_ctx("h36m_train_fp32", {"steps": steps, "batch": 4},
                        TraceData(ops=ops, window_ns=(0, ops[-1][2])), {"depth": depth})) is None


# ------------------------------------------- a second architecture
STANDIN = "standin_net"


def _standin_blocks(m):
    return m["depth"] + 1, 2 * m["depth"]


def _standin_flops(m):
    return 7 * mixste2.forward_flops(m) // 5 + 11


@pytest.fixture
def standin(monkeypatch):
    """An architecture module under a name of its own: MixSTE2's denoiser,
    reference, weights and draws, each call recorded, with an operation
    count and a block layout of its own. Returns the list of calls."""
    calls = []
    mod = types.ModuleType(f"port_bench.arch.{STANDIN}")

    def recorded(name):
        def call(*args, **kwargs):
            calls.append(name)
            return getattr(mixste2, name)(*args, **kwargs)
        return call

    for name in ("parameter_shapes", "denoiser_config", "reference", "step_draws"):
        setattr(mod, name, recorded(name))
    mod.forward_flops, mod.blocks = _standin_flops, _standin_blocks
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    return calls


def _standin_files(cell_of, name, traffic):
    """The files of a new cell `name` on a new configuration naming the
    stand-in, and BENCHMARK.json with new entries only: the configuration,
    the cell, and the cell added to the metrics that `cell_of` reports."""
    bench = copy.deepcopy(common.load_json(REPO / "BENCHMARK.json"))
    old = common.cell_files(cell_of, bench)
    config = dict(copy.deepcopy(old[2]), name="standin_h36m")
    config["model"]["arch"] = STANDIN
    bench["configs"].append({"name": "standin_h36m", "source": "a test",
                             "file": "port_bench/configs/standin_h36m.json", "reduced": [],
                             "why": "a test"})
    cell = {"name": name, "config": "standin_h36m", "traffic": traffic, "chips": 1,
            "why": "a test"}
    bench["workloads"].append(cell)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if cell_of in m.get("workloads", []):
            m["workloads"].append(name)
    return bench, cell, config, old[3], old[4]


@pytest.mark.parametrize("cell_of,traffic,draws", [("h36m_eval_fp32", "eval_stream", False),
                                                   ("h36m_train_fp32", "train_stream", True)])
def test_a_second_architecture_runs_a_cell(standin, cell_of, traffic, draws):
    name = f"standin_{traffic}"
    files = _standin_files(cell_of, name, traffic)
    out = R.run_cell(name, 2 ** 31 + 41, 2, 0, device="cpu", overrides=tiny_overrides(files),
                     files=files)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in
                                   common.metrics_of(files[0], cell_of, "end_to_end")}
    want = {"parameter_shapes", "denoiser_config", "reference"} | ({"step_draws"} if draws
                                                                     else set())
    assert set(standin) == want


def test_a_second_architecture_is_counted_with_its_own_numbers(standin):
    depth, calls, K, rows = 2, 2, 5, 40
    model = {"depth": depth, "arch": STANDIN}
    spatial, temporal = _standin_blocks(model)
    per_name = calls * (spatial + temporal) * K
    ops = _eval_ops(per_name)
    tr = TraceData(ops=ops, window_ns=(0, ops[-1][2] + 10))
    counts = {"sample_calls": calls, "rows": rows, "real_windows": 9, "real_rows_per_window": 10}
    ctx = _ctx("h36m_eval_fp32", counts, tr, model, window_s=2.5)
    k1, k2 = reader("roofline_k1_stage.eval"), reader("roofline_k2_mlp.eval")
    sp, tp = k1.call_bounds_s(rows, 243, 17, 512, "float32")
    k1_time = sum(sum(_seconds(ops, p)) for p in k1.LAUNCHES)
    assert k1.read(ctx) == pytest.approx(100 * calls * K * (spatial * sp + temporal * tp)
                                         / k1_time, rel=1e-12)
    assert k2.read(ctx) == pytest.approx(
        100 * per_name * k2.call_bound_s(rows, 243, 17, 512, 1024, "float32")
        / sum(_seconds(ops, "mlp_block_kernel")), rel=1e-12)
    # MixSTE2's launch count (2 x depth a forward) is not the stand-in's
    ops = _eval_ops(calls * 2 * depth * K)
    assert k1.read(_ctx("h36m_eval_fp32", counts,
                        TraceData(ops=ops, window_ns=(0, ops[-1][2] + 10)), model)) is None

    m = ctx.config["model"]
    assert reader("mfu.eval").read(ctx) == pytest.approx(
        100 * 9 * 10 * K * _standin_flops(m) / 2.5 / PEAK_FLOPS["float32"], rel=1e-12)
    tctx = _ctx("h36m_train_fp32", {"real_chunks": 12}, None, model, window_s=1.5)
    assert reader("mfu.train").read(tctx) == pytest.approx(
        100 * 3 * 12 * _standin_flops(m) / 1.5 / PEAK_FLOPS["float32"], rel=1e-12)

    k4, steps = reader("roofline_k4_attn_bwd.train"), 3
    want = steps * (spatial * k4.launches(17, "float32") + temporal * k4.launches(243, "float32"))
    ops = _ops([("void attn_bwd_key_f32_kernel(float const*)", want, 400_003)])
    tctx = _ctx("h36m_train_fp32", {"steps": steps, "batch": 4},
                TraceData(ops=ops, window_ns=(0, ops[-1][2])), model)
    bound = steps * k4.step_bound_s(4, 243, 17, 512, spatial, temporal, "float32")
    assert k4.read(tctx) == pytest.approx(100 * bound / sum(_seconds(ops, "attn_bwd_")),
                                          rel=1e-12)
    assert standin == []  # the readers need no weights, program or reference

"""Time the attention and MLP kernels of one or more checkouts of the port
in turns on one card, for A/B comparisons:

    python -m d3dp_tpu_torch.utils.time_attention --trees OLD . . OLD --reps 3

Each entry of `--trees` is a directory holding a checkout (its
`d3dp_tpu_torch/` builds its own kernels at first use); a child process per
(repetition, tree) imports the package from there and times, in bf16 (or
`--dtype`) with CUDA events (median of `--iters` launches after one warm-up), every kernel
that runs the attention tile at its main path's shapes: K3 at the train
step's (972 x 17, 68 x 243), K7, K6, K1 and K8 at the eval path's
(9,720 x 17, 680 x 243 for 40 hypothesis rows), and K1's attend launch
alone where the checkout has it; with `--mlp` the MLP kernels instead: K2
(both relayouts) and K5 at the eval path's 40 x 243 x 17 token rows, K2-dp
and K5-dp at the train step's 4 x 243 x 17, and beside each shape the
library sequence computing the same function (F.linear, GELU, F.linear,
layer_norm; timed here, never called by the port); with `--stage` the
stage kernels instead: K1 and K8 at the eval path's spatial and temporal
shapes, each also split into its ln_qkv, attend and proj_ln2 launches
(device time from `torch.profiler`), K6 likewise, K1-dp at the train
step's shapes, the library stage (layer_norm, F.linear, SDPA, F.linear,
the residual, layer_norm) beside each shape, and K9 on 40 rows at depth 8
with its spatial attend phase's share of the launch (`resident_phase_clocks`);
with `--sample` (implied by `--stage`) also `D3DP.sample` at the eval
config at fuse levels 4 and 5 (K1 and K2; K9); with `--bwd` the training
attention core instead: K4 (the backward) and K3 at the train step's shapes,
SDPA's forward and backward beside each (also as device time per call from
`torch.profiler`, without the host's launch cost), and the full-width bf16 train step
(ms per step, random weights and batch from a seed), composed and with
`D3DP_TRAIN_FUSED=1` at fuse level 4.
`--dtype float32` times all of it in fp32, the default dtype of every entry
point (in a checkout whose fp32 kernels take TF32 weight planes, the ops
get them as `planes`, made outside the timed calls as the model's weight
cache makes them; the library calls run with TF32 off).
The inputs come from one seed, so every tree sees the same values. Prints one JSON line per child and a summary
(per kernel and tree: the medians of every repetition), also written to
`chiprun_out/time_attention.json`. Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys

_CHILD = r'''
import json, statistics, sys
import torch
from d3dp_tpu_torch import disable_tf32
from d3dp_tpu_torch.ops import attention as A

disable_tf32()
ITERS = int(sys.argv[1])
MLP = sys.argv[3] == "1"
STAGE = sys.argv[4] == "1"
BWD = sys.argv[5] == "1"
C, HEADS, ROWS, BT, F, J = 512, 8, 40, 4, 243, 17
bf = getattr(torch, sys.argv[6])  # the compute dtype
gen = torch.Generator(device="cuda").manual_seed(11)
try:  # a checkout whose fp32 kernels take TF32 weight planes
    import inspect
    from d3dp_tpu_torch.ops import tf32 as T32
    TAKES = "planes" in inspect.signature(A.attention_stage).parameters
except ImportError:
    T32 = None


def pl(*ws):
    """The `planes` keyword of an fp32 op on weights ws, made here outside
    the timed calls, where the checkout takes them; else no keyword (a
    checkout whose weights carry their planes gets them attached here)."""
    if T32 is None or bf != torch.float32:
        return {}
    if not TAKES:
        for w in ws:
            T32.attach(w)
        return {}
    return dict(planes=tuple(T32.planes(w) for w in ws))


def rn(*shape, s=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * s


def ms(fn, iters=ITERS):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(iters):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


res = {}
if MLP:
    import torch.nn.functional as Fn
    from d3dp_tpu_torch.ops import mlp as M

    H = 2 * C
    w = [rn(C, H, s=0.05).to(bf), rn(H, s=0.01), rn(H, C, s=0.05).to(bf), rn(C, s=0.01),
         1 + rn(C, s=0.1), rn(C, s=0.1)]
    lw = [w[0].t().contiguous(), w[1].to(bf), w[2].t().contiguous(), w[3].to(bf),
          w[4].to(bf), w[5].to(bf)]
    pw = pl(w[0], w[2])
    for label, B0, D1, D2 in (("eval s->t", ROWS, F, J), ("eval t->s", ROWS, J, F),
                              ("train s->t", BT, F, J)):
        x, r = rn(B0, D1, D2, C).to(bf), rn(B0, D1, D2, C).to(bf)
        xr, rr = x.view(-1, C), r.view(-1, C)
        dp = torch.ones(B0, D1, device="cuda")
        dpr = torch.ones(B0 * D1 * D2, device="cuda")
        if label.startswith("train"):
            res[f"mlp_block_t_dp/{label}"] = ms(
                lambda: M.mlp_block_t_dp(x, r, *w, dp, 1e-6, **pw))
            res[f"mlp_block_dp/{label}"] = ms(lambda: M.mlp_block_dp(xr, rr, *w, dpr, 1e-6, **pw))
        else:
            res[f"mlp_block_t/{label}"] = ms(lambda: M.mlp_block_t(x, r, *w, 1e-6, **pw))
            if label.endswith("s->t"):
                res[f"mlp_block/{label}"] = ms(lambda: M.mlp_block(xr, rr, *w, 1e-6, **pw))
        if not label.endswith("t->s"):
            res[f"library/{label}"] = ms(lambda: Fn.layer_norm(
                rr + Fn.linear(Fn.gelu(Fn.linear(xr, lw[0], lw[1])), lw[2], lw[3]), (C,),
                lw[4], lw[5], 1e-6))
        del x, r, xr, rr
if STAGE:
    import torch.nn.functional as Fn
    from torch.profiler import ProfilerActivity, profile
    from d3dp_tpu_torch.ops import resident as RS

    def split(fn, reps=5):
        """Device ms per call of each of the stage's launches, by kernel name."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            for k in ("ln_qkv", "attend", "proj_ln2"):
                if k in e.key and e.self_device_time_total > 0:
                    out[k] = out.get(k, 0.0) + e.self_device_time_total / reps / 1e3
        return out

    def lib_stage(st):
        lw = [st[1].t().contiguous(), st[2].to(bf), st[3].t().contiguous(), st[4].to(bf)] + [
            v.to(bf) for v in st[5:]]
        x = st[0]

        def run():
            R, N, _ = x.shape
            qkv = Fn.linear(Fn.layer_norm(x, (C,), lw[4], lw[5], 1e-6), lw[0], lw[1])
            q, k, v = qkv.view(R, N, 3, HEADS, C // HEADS).permute(2, 0, 3, 1, 4).unbind(0)
            o = Fn.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(R, N, C)
            x2 = x + Fn.linear(o, lw[2], lw[3])
            return x2, Fn.layer_norm(x2, (C,), lw[6], lw[7], 1e-6)
        return run

    w = [rn(C, 3 * C, s=0.05).to(bf), rn(3 * C, s=0.02), rn(C, C, s=0.05).to(bf), rn(C, s=0.02),
         1 + rn(C, s=0.1), rn(C, s=0.1), 1 + rn(C, s=0.1), rn(C, s=0.1)]
    pst, pblk = pl(w[0], w[2]), pl(w[2])
    for label, R, N in (("spatial", ROWS * F, J), ("temporal", ROWS * J, F)):
        st = [rn(R, N, C, s=0.5).to(bf), *w]
        hm = [st[0], *A.stack_head_major(st[1], st[2], HEADS), *st[3:]]
        phm = pl(hm[1], w[2])
        blk = [rn(R, N, 3 * C).to(bf), st[0], w[2], w[3], w[6], w[7]]
        for name, fn in (("K1", lambda: A.attention_stage(*st, HEADS, 0.125, 1e-6, **pst)),
                         ("K8", lambda: A.attention_stage_hm(*hm, HEADS, 0.125, 1e-6, **phm)),
                         ("K6", lambda: A.attention_block(*blk, HEADS, 0.125, 1e-6, **pblk))):
            res[f"{name}/{label}"] = ms(fn)
            for k, v in split(fn).items():
                res[f"{name} {k}/{label}"] = v
        res[f"library stage/{label}"] = ms(lib_stage(st))
        del st, hm, blk
    for label, R, N in (("train spatial", BT * F, J), ("train temporal", BT * J, F)):
        st = [rn(R, N, C, s=0.5).to(bf), *w]
        dp = torch.where(torch.rand(R, generator=gen, device="cuda") < 0.9, 1 / 0.9, 0.0)
        res[f"K1-dp/{label}"] = ms(
            lambda: A.attention_stage_dp(*st, dp, HEADS, 0.125, 1e-6, **pst))
        res[f"library stage/{label}"] = ms(lib_stage(st))
    # K9 on the eval path's 40 rows at depth 8, random weights of std 0.05
    D, HID = 8, 2 * C

    def kind():
        vec = rn(D, 6, C, s=0.05)
        vec[:, [1, 3]] += 1.0
        return (rn(D, C, 3 * C, s=0.05).to(bf), rn(D, 1, 3 * C, s=0.02),
                rn(D, C, C, s=0.05).to(bf), rn(D, C, HID, s=0.05).to(bf), rn(D, 1, HID, s=0.02),
                rn(D, HID, C, s=0.05).to(bf), vec)
    trunk = (rn(ROWS, F, J, C).to(bf), rn(F, C, s=0.1), kind(), kind(),
             rn(4, C, s=0.05) + torch.tensor([1.0, 0, 1.0, 0], device="cuda")[:, None])
    ptr = [pl(*(kind[i] for i in (0, 2, 3, 5))) for kind in trunk[2:4]]
    ptr = dict(planes=tuple(p["planes"] for p in ptr)) if all(ptr) else {}
    res["K9/eval depth 8"] = ms(
        lambda: RS.resident_block_stack(*trunk, HEADS, 0.125, 1e-6, **ptr), iters=5)
    # K9's spatial attend phase from the build with per-phase clocks: its
    # share of the launch's block cycles (tiles and barrier), and that share
    # of the event-timed launch
    sums = RS.resident_phase_clocks(*trunk, HEADS, 0.125, 1e-6)
    share = sum(sums["spatial attend"]) / sum(w + b for w, b in sums.values())
    res["K9 spatial attend share/eval depth 8"] = share
    res["K9 spatial attend ms/eval depth 8"] = share * res["K9/eval depth 8"]
    del trunk
if BWD:
    import os, time
    import torch.nn.functional as Fn
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT
    from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
    from d3dp_tpu_torch.models import MixSTEConfig
    from d3dp_tpu_torch.train.state import make_optimizer, make_train_step

    from torch.profiler import ProfilerActivity, profile

    def dev_ms(fn, reps=10):
        """Device time per call of every kernel fn launches (torch.profiler):
        the event time of one call also holds the host's launch cost."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()) / reps / 1e3

    for label, R, N in (("train spatial", BT * F, J), ("train temporal", BT * J, F)):
        qkv, dout = rn(R, N, 3 * C).to(bf), rn(R, N, C).to(bf)
        leaf = qkv.clone().requires_grad_(True)

        def sdpa(x):
            q, k, v = x.view(R, N, 3, HEADS, C // HEADS).permute(2, 0, 3, 1, 4).unbind(0)
            return Fn.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(R, N, C)
        out = sdpa(leaf)
        for name, fn in (
                ("K4", lambda: A.fused_attention_qkv_bwd(qkv, dout, HEADS, 0.125)),
                ("K3", lambda: A.fused_attention_qkv(qkv, HEADS, 0.125)),
                ("SDPA", lambda: sdpa(qkv)),
                ("SDPA backward", lambda: torch.autograd.grad(out, leaf, dout,
                                                              retain_graph=True))):
            res[f"{name}/{label}"] = ms(fn)
            res[f"{name} device/{label}"] = dev_ms(fn)
        del qkv, dout, leaf, out
    # the train step at the train config (4 chunks of 243 frames, bf16,
    # DropPath 0.1, AdamW), one random batch, host clock around synchronised
    # steps: mean of 10 after 3 warm-up steps
    d3dp = D3DP(D3DPConfig(model=MixSTEConfig(num_frames=F, embed_dim=C, depth=8,
                                              num_heads=HEADS, drop_path_rate=0.1, dtype=bf),
                           num_proposals=1, sampling_timesteps=1,
                           joints_left=tuple(JOINTS_LEFT), joints_right=tuple(JOINTS_RIGHT)),
                seed=0)
    step = make_train_step(d3dp, make_optimizer(d3dp.model.parameters(), 6e-5))
    x2d, x3d, w = rn(BT, F, J, 2, s=0.3), rn(BT, F, J, 3, s=0.3), torch.ones(BT, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, fused in (("train step composed", "0"), ("train step fused level 4", "1")):
        os.environ["D3DP_TRAIN_FUSED"] = fused
        for i in range(13):
            if i == 3:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            step(x2d, x3d, w, generator=g)
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t0) * 1e3 / 10
    os.environ.pop("D3DP_TRAIN_FUSED")
    del d3dp, step
ATTN = not (MLP or STAGE or BWD)
for label, R, N in (("spatial", BT * F, J), ("temporal", BT * J, F)) if ATTN else ():
    qkv = rn(R, N, 3 * C).to(bf)
    res[f"fused_attention_qkv/{label}"] = ms(lambda: A.fused_attention_qkv(qkv, HEADS, 0.125))
for label, R, N in (("spatial", ROWS * F, J), ("temporal", ROWS * J, F)) if ATTN else ():
    qkv = rn(R, N, 3 * C).to(bf)
    q, k, v = (t.contiguous() for t in qkv.split(C, dim=-1))
    res[f"fused_attention_packed/{label}"] = ms(
        lambda: A.fused_attention_packed(q, k, v, HEADS, 0.125))
    if hasattr(A, "attend_qkv"):
        res[f"attend/{label}"] = ms(lambda: A.attend_qkv(qkv, HEADS, 0.125))
    res_ = rn(R, N, C, s=0.5).to(bf)
    blk = [qkv, res_, rn(C, C, s=0.05).to(bf), rn(C, s=0.02), 1 + rn(C, s=0.1), rn(C, s=0.1)]
    pblk = pl(blk[2])
    res[f"attention_block/{label}"] = ms(
        lambda: A.attention_block(*blk, HEADS, 0.125, 1e-6, **pblk))
    del q, k, v, qkv, blk
    st = [rn(R, N, C, s=0.5).to(bf), rn(C, 3 * C, s=0.05).to(bf), rn(3 * C, s=0.02),
          rn(C, C, s=0.05).to(bf), rn(C, s=0.02), 1 + rn(C, s=0.1), rn(C, s=0.1),
          1 + rn(C, s=0.1), rn(C, s=0.1)]
    pst = pl(st[1], st[3])
    res[f"attention_stage/{label}"] = ms(
        lambda: A.attention_stage(*st, HEADS, 0.125, 1e-6, **pst))
    hm = [st[0], *A.stack_head_major(st[1], st[2], HEADS), *st[3:]]
    phm = pl(hm[1], st[3])
    res[f"attention_stage_hm/{label}"] = ms(
        lambda: A.attention_stage_hm(*hm, HEADS, 0.125, 1e-6, **phm))
    del st, hm
if sys.argv[2] == "1" or STAGE:
    # D3DP.sample at the eval config (B=4 windows, H=5, K=5, flip-TTA, depth 8,
    # random weights from seed 0) at fuse levels 4 and 5, host clock around
    # synchronised calls
    import dataclasses, time
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT
    from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
    from d3dp_tpu_torch.models import MixSTEConfig

    d3dp = D3DP(D3DPConfig(model=MixSTEConfig(num_frames=F, embed_dim=C, depth=8,
                                              num_heads=HEADS, dtype=bf),
                           num_proposals=5, sampling_timesteps=5,
                           joints_left=tuple(JOINTS_LEFT), joints_right=tuple(JOINTS_RIGHT)),
                seed=0)
    x2d, x2d_f = rn(BT, F, J, 2, s=0.3), rn(BT, F, J, 2, s=0.3)
    for level in (4, 5):
        d3dp.model.cfg = dataclasses.replace(d3dp.model.cfg, fuse_level=level)
        times = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d3dp.sample(x2d, x2d_f, generator=torch.Generator(device="cuda").manual_seed(3))
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        res[f"sample/level{level}"] = statistics.median(times[1:])
print("RESULT " + json.dumps(res), flush=True)
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sample", action="store_true",
                    help="also time D3DP.sample at fuse levels 4 and 5 (median of 3)")
    ap.add_argument("--mlp", action="store_true",
                    help="time the MLP kernels and the library sequence instead of the "
                         "attention kernels")
    ap.add_argument("--stage", action="store_true",
                    help="time the stage kernels (K1, K8, K6 split by launch; K1-dp; K9; "
                         "the library stage) and D3DP.sample at levels 4 and 5 instead")
    ap.add_argument("--bwd", action="store_true",
                    help="time K4 and K3 at the train shapes beside SDPA's forward and "
                         "backward, and the train step (composed, and fused at level 4) "
                         "instead")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the compute dtype of every kernel, model and library call timed "
                         "(float32: the library calls with TF32 off)")
    args = ap.parse_args(argv)
    runs = []
    for rep in range(args.reps):
        for tree in args.trees:
            out = subprocess.run([sys.executable, "-c", _CHILD, str(args.iters),
                                  str(int(args.sample)), str(int(args.mlp)),
                                  str(int(args.stage)), str(int(args.bwd)), args.dtype],
                                 cwd=tree,
                                 capture_output=True, text=True, timeout=900)
            line = [x for x in out.stdout.splitlines() if x.startswith("RESULT ")]
            if out.returncode != 0 or not line:
                print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"time_attention: tree {tree} failed (rc {out.returncode})")
            res = json.loads(line[0][len("RESULT "):])
            runs.append({"rep": rep, "tree": tree, "ms": res})
            print(json.dumps(runs[-1]), flush=True)
    summary = {}
    for r in runs:
        for name, v in r["ms"].items():
            summary.setdefault(name, {}).setdefault(r["tree"], []).append(v)
    for name, by_tree in summary.items():
        print(f"{name:34s} " + "  ".join(
            f"{t}: {', '.join(f'{v:.4f}' for v in vs)}" for t, vs in by_tree.items()), flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "time_attention.json"), "w") as f:
        json.dump({"runs": runs, "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

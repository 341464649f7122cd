#!/usr/bin/env python3
"""Smoke run of the d3dp_tpu_torch port on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --tp-depth 4   # only the tp rounding probe below
    python3 chip_smoke.py --fp32-rows    # only the fp32 tp and grouped rows
    python3 chip_smoke.py --fp32-truth   # only phase env and phase fp32_truth
    python3 chip_smoke.py --linear       # only phase env, the tf32x3 linears, fp32 train steps

Builds the hand-written kernels from `d3dp_tpu_torch/ops/csrc/`, holds each
against its plain torch version on the card (the stage kernels also at
token-row counts around their 64-row tiles, the attention backward at its
tiles' edges and for bit-determinism; the depth-resident trunk
kernel first at depth 1 in a child process under a time limit, so that a
kernel that never finishes becomes an error), checks the full-width MixSTE2
on the kernel path against the plain path (eval forward at every fuse
level, and the training loss and gradients), then drives the port's paths
at MixSTE2's published width (C=512, 8 heads, depth 8, 243 frames) with
random weights from a fixed seed:
  * evaluation: multi-hypothesis DDIM sampling (H=5, K=5, bf16, flip-TTA)
    and the four-mode Evaluator, then one timed sampling call at each fuse
    level 0-5;
  * fp32, the default dtype of every entry point (phases timing and
    resident): `D3DP.sample` at the eval config at fuse level 4 (timed and
    profiled), and every eval kernel's fp32 form at the bf16 rows' shapes
    (K1 also split into its three launches; K9 at depth 8) against its
    bound at the three-pass TF32 rate, the FMA figure, its plain version
    and the library calls in fp32 with TF32 off;
  * fp32 against float64 (phase fp32_truth): each contraction of the fp32
    walks (o @ Wp, fc1, fc2) at its whole K against its own operands
    multiplied in float64 on the card, at the card tests' inputs and at the
    model's depth-0 and depth-7 activations; the whole forms K1, K2 and K5
    against their functions in float64; fp32 `D3DP.sample` at levels 4 and
    5 on one window against tests/fp64_truth.py's sampler in float64, beside
    the plain fp32 composition; the block linears' tf32x3 GEMM
    (`ops.linear`) at the train step's eight products and ragged row counts
    against float64, within twice cuBLAS's fp32 error, its split kernel's
    planes equal to `ops.tf32.planes`, each product timed beside cuBLAS and
    its three-pass bound (`linear_rows`);
  * fuse level 5 (the whole trunk in one launch) against level 4, its
    kernel timed and profiled, its time split by phase from the build with
    per-phase clocks, and sampling with DDIM feature reuse;
  * training: the default train step (bf16 compute, fp32 AdamW at 6e-5,
    DropPath 0.1, batch 4 chunks of 243 frames from ChunkedGenerator),
    then light validation on the trained weights; fp32 steps with the
    block linears' GEMM launched 128 times a step;
  * the `D3DP_TRAIN_FUSED=1` training path: fp32 loss and gradients at
    fuse levels 1-4 against the composed path, then timed steps at level 4
    (the DropPath forms of the stage and MLP kernels, their backwards as
    autograd Functions) beside the composed path's;
  * evaluation with the head-major stage kernel (`D3DP_ATTN_VARIANT=hmqkv`)
    against level 4 without it;
  * the packed-attention op through its public wrapper;
  * the lab switches (`D3DP_SOFTMAX_FOLD=0`, `D3DP_ATTN_VARIANT=bf16exp` and
    noy2, `D3DP_SPATIAL_GROUP`, `D3DP_MLP_VARIANT=bf16gelu` and nogelu):
    each switch's instantiation of K1, K1-dp, K2, K2-dp, K5, K5-dp, K8 and
    K9 against its plain version and timed, then sampling at levels 1, 4
    and 5, a train-fused step and the public ops under each switch, with
    launch counts, level 5 equal to level 4 under every global switch;
  * Protocol-2 on the device (`Evaluator(p2_device=True)`) against the
    host's, with the alignment's time and host synchronizations;
  * the H36M command line (`d3dp_tpu_torch.cli.main_h36m`, in process):
    one training epoch with checkpoints, a resumed epoch, and evaluation of
    the best checkpoint at every fuse level 0-5, with feature reuse and
    with `--p2-device`;
  * the MPI-INF-3DHP command line (`d3dp_tpu_torch.cli.main_3dhp`, in
    process): a training epoch, a resumed epoch, and evaluation at the 3DHP
    config (H=20, K=10, 2 windows a micro-batch: 80 hypothesis rows) at
    fuse levels 4 and 5 with the four .mat exports, then the PCK/AUC tables
    of the exports;
  * the in-the-wild, render and draw entry points (phase wild): the
    in-the-wild pipeline on a 1,000-frame track at fuse levels 4 and 5,
    `--render --viz-export` and main_draw on the synthetic data, the
    in-the-wild `main` on an npz track where cv2 is installed, and the
    plots and the gif where matplotlib is;
  * data-parallel training and evaluation (phase dp, `parallel/`): two
    ranks sharing the card over gloo train 3 steps (2 chunks a rank, fp32
    and bf16) and evaluate one Eval-config micro-batch (2 windows, 20
    hypothesis rows a rank) at fuse levels 4 and 5, against one process on
    the same batches and noise (bf16 parameters without the qkv key
    bias, whose exact gradient is zero), with exact launch counts a rank; a world
    of one over NCCL equal to the run without a mesh; NCCL over two cards
    where the box has them; K1, K2 and K9 at a rank's 20 rows;
  * the host side of training (phase host): the native chunk assembler
    (asserted to run, timed a batch against numpy), and the command line
    with `--ckpt-format orbax --input-pipeline grain` (a training epoch
    against the default flags' and a resumed epoch);
  * tensor-parallel evaluation and training (phase tp, `--tp`): the partial
    forms of the stage (K1-tp and the head-major K8-tp), block and MLP
    kernels and the residual-LayerNorm epilogue (with and without its
    DropPath scale) against their plain versions at tp 2 and 4, their sums
    over the ranks against the whole kernels (K1-dp, K2-dp and K5-dp
    through the DropPath form), each timed at a rank's rows; two ranks at
    tp=2 sharing the card over gloo evaluate one Eval-config window at
    fuse levels 2-5 and at bf16 level 4 under `D3DP_ATTN_VARIANT=hmqkv`,
    the whole kernels on the gathered weights, equal to one process bit
    for bit, train 3 steps (fp32 and bf16) and 2 `D3DP_TRAIN_FUSED=1`
    steps (level 4, DropPath 0.1) against one process, and one bf16
    `D3DP_TRAIN_FUSED=1` step at level 3 and one under hmqkv, with exact
    launch counts a rank;
  * `D3DP.sample` at a per-call H and K (phase call_args), at fuse levels 4
    and 5, against a sampler configured with them;
and times them. The stage, MLP and trunk kernels are also held against
their plain versions at the 3DHP evaluation's 80 hypothesis rows. Every phase raises on failure; the script exits non-zero
without a CUDA device and prints nothing then but the reason. The last
stdout line is the run's JSON status; the line before it the per-kernel
JSON. Details also go to `chiprun_out/chip_smoke.json` (the fp32 rows under
`kernel_rows_fp32` and `resident.trunk_fp32`, the fp32 sample under
`sample_seconds_fp32` and `profile_fp32`), and the command
lines' own output to `chiprun_out/chip_smoke_cli.log`,
`chiprun_out/chip_smoke_host.log`, `chiprun_out/chip_smoke_cli_3dhp.log` and
`chiprun_out/chip_smoke_wild.log`.
Phase dp's and phase tp's per-rank launch counts are `{"dp_launches": ...}`
and `{"tp_launches": ...}` lines of their own, before the last two lines.

`--tp-depth N` runs only a probe of tensor-parallel evaluation at another
depth: phase tp's fp32 level-4 evaluation, with and without hmqkv, at
depth N on two ranks over gloo against one process, printing the four
modes' gap and whether each prediction equals one process's.

`--fp32-rows` runs only phase tp's fp32 timing rows (`tp_kernel_rows_fp32`),
the lab phase's grouped fp32 rows (`group_rows_fp32`) and the fp32
`D3DP.sample` at level 4 ungrouped and grouped (`group_sample_fp32`), and
prints them as one `RESULT {...}` JSON line. Copied into another checkout of the port, it
times that checkout's kernels with the same code: run it in the parent's
tree and the change's in turns to compare the two on one card.

`--fp32-truth` runs only phase env (the build and ptxas's registers and
spills) and phase fp32_truth, and prints the latter's readings as one
`RESULT {...}` JSON line; copied into another checkout (with
tests/fp64_truth.py), it reads that checkout's walks.

`--linear` runs only phase env, the block linears' tf32x3 GEMM rows
(`linear_rows`) and phase train's fp32 steps (the GEMM launched 128 times a
step, counted by `.launches` and the recorder's `linear_tf32x3`, and one
profiled step's device time), and prints them as one `RESULT {...}` line.
"""

import argparse

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

B, H, K, F, J, C, HEADS, HIDDEN, DEPTH = 4, 5, 5, 243, 17, 512, 8, 1024, 8
ROWS = 2 * B * H  # flip-TTA doubles the hypothesis-folded batch
# the MPI-INF-3DHP evaluation config (README's main_3dhp command line): 2
# windows a micro-batch, H=20, K=10, flip-TTA: 80 hypothesis rows
B_3DHP, H_3DHP, K_3DHP = 2, 20, 10
ROWS_3DHP = 2 * B_3DHP * H_3DHP
BT = 4  # training batch: 4 chunks of 243 frames (bench.py's train config)
TRAIN_SHAPES = (("spatial", BT * F, J), ("temporal", BT * J, F))  # (label, R, N)
TRAIN_STEPS = 20
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
# fp32: the tensor cores give an fp32-accurate product in three TF32 passes
# (the fp32 kernels' tf32x3), so fp32's least time is 3 x FLOPs at the dense
# TF32 rate; beside it the FMA figure, FLOPs at the float32 rate outside the
# tensor cores (both NVIDIA data sheet)
PEAK_TF32 = 495e12
PEAK_FP32_FMA = 67e12
HBM = 3.35e12  # bytes/s
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# K3/K4: unit-normal qkv at scale 1/8 gives outputs and gradients of about
# 0.1, so the bf16 absolute term is 1e-2 there, which a dropped or doubled
# 16-key tile would exceed
TOL_QKV = {"float32": 1e-4, "bfloat16": 1e-2}
BF16_ULP = 2.0 ** -7  # one bf16 ulp relative to the magnitude, upper bound


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


# ------------------------------------------------------------------ helpers
def time_ms(torch, fn, reps):
    """Median of `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def bound_ms(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def stage_inputs(torch, gen, R, N, dt):
    dev = "cuda"

    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * s

    return [(rn(R, N, C) * 0.5).to(dt), rn(C, 3 * C, s=0.05).to(dt), rn(3 * C, s=0.02),
            rn(C, C, s=0.05).to(dt), rn(C, s=0.02), 1 + rn(C, s=0.1), rn(C, s=0.1),
            1 + rn(C, s=0.1), rn(C, s=0.1)]


def mlp_inputs(torch, gen, D1, D2, dt, rows=ROWS):
    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * s

    return [rn(rows, D1, D2, C).to(dt), rn(rows, D1, D2, C).to(dt), rn(C, HIDDEN, s=0.05).to(dt),
            rn(HIDDEN, s=0.02), rn(HIDDEN, C, s=0.05).to(dt), rn(C, s=0.02), 1 + rn(C, s=0.1),
            rn(C, s=0.1)]


def qkv_inputs(torch, gen, R, N, dt):
    """Packed qkv (R, N, 3C) and an output gradient (R, N, C), unit normal."""
    return (torch.randn(R, N, 3 * C, generator=gen, device="cuda").to(dt),
            torch.randn(R, N, C, generator=gen, device="cuda").to(dt))


def max_err(torch, got, want, ulp_rel):
    """(max |got - want|, max of |got - want| - ulp_rel*|want|): a bf16
    output may sit one bf16 ulp of its own magnitude away, since its
    roundings fall at other places than in the plain version."""
    d = (got.float() - want.float()).abs()
    return d.max().item(), (d - ulp_rel * want.float().abs()).max().item()


class ResidualLnDp:
    """residual_ln's DropPath launches (`residual_ln.dp_launches`, the
    kernel's `dp` option) as an op's `.launches`."""

    @property
    def launches(self):
        from d3dp_tpu_torch.ops.residual_ln import residual_ln
        return residual_ln.dp_launches

    @launches.setter
    def launches(self, n):
        from d3dp_tpu_torch.ops.residual_ln import residual_ln
        residual_ln.dp_launches = n


def kernel_ops():
    """{name: wrapper} of every kernel's op, each with its `.launches`."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M

    from d3dp_tpu_torch.ops import resident as R
    from d3dp_tpu_torch.ops.residual_ln import residual_ln

    return {"attention_stage": A.attention_stage, "mlp_block_t": M.mlp_block_t,
            "fused_attention_qkv": A.fused_attention_qkv,
            "fused_attention_qkv_bwd": A.fused_attention_qkv_bwd, "mlp_block": M.mlp_block,
            "attention_block": A.attention_block,
            "fused_attention_packed": A.fused_attention_packed,
            "resident_block_stack": R.resident_block_stack,
            "attention_stage_dp": A.attention_stage_dp, "mlp_block_t_dp": M.mlp_block_t_dp,
            "mlp_block_dp": M.mlp_block_dp, "attention_stage_hm": A.attention_stage_hm,
            "attention_stage_partial": A.attention_stage_partial,
            "attention_block_partial": A.attention_block_partial,
            "mlp_block_partial": M.mlp_block_partial, "residual_ln": residual_ln,
            "attention_stage_hm_partial": A.attention_stage_hm_partial,
            "residual_ln[dp]": ResidualLnDp()}


def reset_counts():
    for f in kernel_ops().values():
        f.launches = 0


def read_counts():
    return {name: f.launches for name, f in kernel_ops().items()}


@contextlib.contextmanager
def env_var(name, value):
    """Set (or, with None, unset) one environment variable for a block."""
    saved = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = saved


@contextlib.contextmanager
def plain_ops():
    """Run the model through the plain torch versions (comparison only)."""
    from d3dp_tpu_torch.ops import attention, mlp, resident

    swaps = [(attention, "attention_stage"), (mlp, "mlp_block_t"),
             (attention, "fused_attention_qkv"), (attention, "fused_attention_qkv_bwd"),
             (mlp, "mlp_block"), (attention, "attention_block"),
             (attention, "fused_attention_packed"), (resident, "resident_block_stack"),
             (attention, "attention_stage_dp"), (mlp, "mlp_block_t_dp"), (mlp, "mlp_block_dp"),
             (attention, "attention_stage_hm")]
    saved = [getattr(mod, name) for mod, name in swaps]
    plain = {"fused_attention_packed": "fused_attention_plain"}

    def without_planes(f):
        # the plain versions multiply the weights themselves: the fp32
        # kernels' `planes` argument means nothing to them
        return lambda *a, planes=None, **k: f(*a, **k)

    for mod, name in swaps:
        setattr(mod, name, without_planes(getattr(mod, plain.get(name, name + "_plain"))))
    try:
        yield
    finally:
        for (mod, name), f in zip(swaps, saved):
            setattr(mod, name, f)


def perturb_(torch, model, seed):
    """Give every parameter a seeded random offset, so biases, position
    embeddings and LN affines are not at their trivial init."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g, device=p.device) * 0.02)


# ------------------------------------------------------------------- phases
def phase_env(torch, record):
    from d3dp_tpu_torch import disable_tf32
    from d3dp_tpu_torch.ops import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    log(card)  # name and power limit, exactly as nvidia-smi prints them
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    out = _build.build_all(_build.SOURCES + tuple(_build.VARIANTS))
    dt = time.perf_counter() - t0
    log(f"[env] kernels built in {dt:.1f} s -> {out}")
    ptxas = []
    for name in _build.SOURCES:
        logf = out / f"{name}.log"
        if logf.exists():
            rep = _build.ptxas_report(logf.read_text())
            for r, full in zip(rep, _build.demangle([r["kernel"] for r in rep])):
                r.update(source=name, kernel=full.split("(")[0])
                ptxas.append(r)
    # every kernel's registers and spills, then those of the bf16 attention
    # tile's, attention backward's, MLP tile's and stage GEMM walks' kernels
    # and of the depth-resident kernel, which runs all but the backward
    for r in ptxas:
        log(f"[env] ptxas {r['source']}: {r['kernel']}: {r.get('registers')} registers, "
            f"{r.get('spill_stores')} bytes spill stores, {r.get('spill_loads')} bytes spill "
            f"loads, {r.get('stack')} bytes stack")
    bf16_keys = ("attend", "attend_short", "attn_bwd_block", "attn_bwd_warp", "resident",
                 "mlp_block", "ln_qkv_walk", "proj_ln2_walk", "residual_ln")
    tile = [r for r in ptxas if any(k in r["kernel"] for k in bf16_keys)
            and "<float" not in r["kernel"] and "_f32" not in r["kernel"]]
    for k in bf16_keys[1:]:
        check(any(k in r["kernel"] for r in tile), f"no bf16 {k} kernel in the ptxas output")
    for r in tile:
        if "attn_bwd" in r["kernel"]:
            log(f"[env] bf16 attention backward {r['kernel']}: {r.get('registers')} registers, "
                f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes spilled")
    # the short tile (bf16, N <= 32 keys: every spatial stage), in each
    # library that launches it (K9 inlines it)
    short = [r for r in tile if "attend_short" in r["kernel"]]
    for r in short:
        log(f"[env] bf16 short attention tile ({r['source']}): {r.get('registers')} registers, "
            f"{r.get('spill_stores')} / {r.get('spill_loads')} bytes spilled, "
            f"{r.get('stack')} bytes stack")
    check(all(not r.get("spill_stores") and not r.get("spill_loads") for r in short),
          "the short attention tile spills")
    spills = sorted({f"{r['kernel']} ({r['spill_stores']} / {r['spill_loads']} bytes)"
                     for r in tile if r.get("spill_stores") or r.get("spill_loads")})
    log(f"[env] bf16 attention tile and backward, MLP tile, stage walks (their tensor-parallel "
        f"partial forms among them), residual_ln and K9: {len(tile)} "
        f"kernels, spilling: {', '.join(spills) if spills else 'none'}")
    # the fp32 bodies: ln_qkv and proj_ln2 (K1, K1-dp, K8, K6), the MLP (K2,
    # K5 and their -dp forms) and the tensor-core attention walk (tf32x3),
    # the short attention tile (FMAs), K9, which inlines them, and K4's
    # tf32x3 kernels (its query and key passes, its short tile)
    f32_keys = ("ln_qkv_walk_f32", "proj_ln2_walk_f32", "mlp_block_kernel<float",
                "attend_f32_kernel", "attend_short_kernel<float", "resident_kernel<float",
                "attn_bwd_query_f32", "attn_bwd_key_f32", "attn_bwd_short_f32",
                "linear_tf32x3_kernel", "tf32_planes_kernel")
    for k in f32_keys:
        walks = [r for r in ptxas if k in r["kernel"]]
        check(walks, f"no fp32 {k} kernel in the ptxas output")
        for r in walks:
            log(f"[env] fp32 walk {r['kernel']} ({r['source']}): {r.get('registers')} "
                f"registers, {r.get('spill_stores')} / {r.get('spill_loads')} bytes spilled, "
                f"{r.get('stack')} bytes stack")
    disable_tf32()
    record.update(card=card, torch=torch.__version__, cuda=torch.version.cuda, build_s=dt,
                  ptxas=ptxas)
    return card


def phase_kernels(torch, record):
    """Each kernel against its plain version, at the main path's shapes, in
    fp32 and bf16."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {name: 0.0 for name in kernel_ops()}
    for dt in (torch.float32, torch.bfloat16):
        name_dt = str(dt).split(".")[1]
        tol = TOL[name_dt]
        ulp = BF16_ULP if dt == torch.bfloat16 else 0.0
        for label, R, N in (("spatial", ROWS * F, J), ("temporal", ROWS * J, F)):
            args = stage_inputs(torch, gen, R, N, dt)
            got = A.attention_stage(*args, HEADS, (C // HEADS) ** -0.5, 1e-6)
            want = A.attention_stage_plain(*args, HEADS, (C // HEADS) ** -0.5, 1e-6)
            torch.cuda.synchronize()
            e_x2, ex_x2 = max_err(torch, got[0], want[0], ulp)
            e_y2, ex_y2 = max_err(torch, got[1], want[1], ulp)
            ok = ex_x2 <= tol and ex_y2 <= tol
            log(f"[kernels] attention_stage {label} {name_dt} x{tuple(args[0].shape)}: "
                f"max|err| x2 {e_x2:.3e} y2 {e_y2:.3e} (tol {tol:g}"
                f"{' + 1 bf16 ulp' if ulp else ''}) {'ok' if ok else 'FAIL'}")
            check(ok, f"attention_stage {label} {name_dt} disagrees with its plain version")
            if dt == torch.bfloat16:
                errs["attention_stage"] = max(errs["attention_stage"], e_x2, e_y2)
            del args, got, want
        for label, D1, D2 in (("spatial->temporal", F, J), ("temporal->spatial", J, F)):
            args = mlp_inputs(torch, gen, D1, D2, dt)
            got = M.mlp_block_t(*args, 1e-6)
            want = M.mlp_block_t_plain(*args, 1e-6)
            torch.cuda.synchronize()
            e, ex = max_err(torch, got, want, ulp)
            log(f"[kernels] mlp_block_t {label} {name_dt} x{tuple(args[0].shape)} -> "
                f"{tuple(got.shape)}: max|err| {e:.3e} (tol {tol:g}{' + 1 bf16 ulp' if ulp else ''}) "
                f"{'ok' if ex <= tol else 'FAIL'}")
            check(ex <= tol, f"mlp_block_t {label} {name_dt} disagrees with its plain version")
            if dt == torch.bfloat16:
                errs["mlp_block_t"] = max(errs["mlp_block_t"], e)
            del args, got, want
        # the training path's attention core (K3) and its backward (K4), at
        # the train step's shapes
        tol = TOL_QKV[name_dt]
        for label, R, N in TRAIN_SHAPES:
            qkv, dout = qkv_inputs(torch, gen, R, N, dt)
            for name, got, want in (
                    ("fused_attention_qkv", A.fused_attention_qkv(qkv, HEADS, 0.125),
                     A.fused_attention_qkv_plain(qkv, HEADS, 0.125)),
                    ("fused_attention_qkv_bwd", A.fused_attention_qkv_bwd(qkv, dout, HEADS, 0.125),
                     A.fused_attention_qkv_bwd_plain(qkv, dout, HEADS, 0.125))):
                torch.cuda.synchronize()
                e, ex = max_err(torch, got, want, ulp)
                log(f"[kernels] {name} {label} {name_dt} qkv{tuple(qkv.shape)}: max|err| {e:.3e} "
                    f"(tol {tol:g}{' + 1 bf16 ulp' if ulp else ''}) {'ok' if ex <= tol else 'FAIL'}")
                check(ex <= tol, f"{name} {label} {name_dt} disagrees with its plain version")
                if dt == torch.bfloat16:
                    errs[name] = max(errs[name], e)
            if dt == torch.float32:
                # K4 against autograd through K3's plain version
                leaf = qkv.clone().requires_grad_(True)
                (want,) = torch.autograd.grad(A.fused_attention_qkv_plain(leaf, HEADS, 0.125),
                                              leaf, dout)
                got = A.fused_attention_qkv_bwd(qkv, dout, HEADS, 0.125)
                torch.cuda.synchronize()
                e, ex = max_err(torch, got, want, 0.0)
                log(f"[kernels] fused_attention_qkv_bwd {label} fp32 vs autograd of the plain "
                    f"forward: max|err| {e:.3e} (tol {tol:g}) {'ok' if ex <= tol else 'FAIL'}")
                check(ex <= tol, f"fused_attention_qkv_bwd {label} disagrees with autograd")
            del qkv, dout, got, want
        check_bwd_tiles(torch, gen, dt, name_dt)
        check_mlp_tile_edges(torch, gen, dt, name_dt, errs)
        check_stage_tile_edges(torch, gen, dt, name_dt, errs)
        check_eval_kernels(torch, gen, dt, name_dt, errs)
        check_train_fused_kernels(torch, gen, dt, name_dt, errs)
        check_resident_kernel(torch, dt, name_dt, errs)
        check_3dhp_rows(torch, gen, dt, name_dt, errs)
    check_backwards(torch, record)
    record["max_abs_err_bf16"] = errs
    return errs


def check_mlp_tile_edges(torch, gen, dt, name_dt, errs):
    """K5 and K5-dp on token-row counts around the MLP walk's 64-row tiles
    (both dtypes): fewer than a tile, one under and over one and two tiles,
    and 3 x 243 x 17 (41 rows in the last tile), against their plain
    versions."""
    from d3dp_tpu_torch.ops import mlp as M

    tol = TOL[name_dt]
    ulp = BF16_ULP if dt == torch.bfloat16 else 0.0
    for R in (17, 63, 65, 127, 129, 3 * F * J):
        args = mlp_inputs(torch, gen, R, 1, dt, rows=1)
        args[:2] = [a.view(R, C) for a in args[:2]]
        dp = dp_scales(torch, gen, (R,))
        for name, got, want in (
                ("mlp_block", M.mlp_block(*args, 1e-6), M.mlp_block_plain(*args, 1e-6)),
                ("mlp_block_dp", M.mlp_block_dp(*args, dp, 1e-6),
                 M.mlp_block_dp_plain(*args, dp, 1e-6))):
            torch.cuda.synchronize()
            e, ex = max_err(torch, got, want, ulp)
            log(f"[kernels] {name} tile edge {name_dt} rows({R}, {C}): max|err| {e:.3e} "
                f"(tol {tol:g}{' + 1 bf16 ulp' if ulp else ''}) {'ok' if ex <= tol else 'FAIL'}")
            check(ex <= tol, f"{name} on {R} rows {name_dt} disagrees with its plain version")
            if dt == torch.bfloat16:
                errs[name] = max(errs[name], e)
        del args, dp


# (R, N) around K4's tiles: bf16 a warp a tile at 16 and 32 keys or fewer, a
# block a tile of 64, 128 or 256 keys above; fp32 two warps a tile at 32 or
# fewer, 64-row tiles over groups of 32 keys above; rows past a 16-row group
BWD_TILE_SHAPES = ((3, 1), (3, 8), (6, 16), (3, 31), (5, 32), (5, 33), (4, 48), (4, 63),
                   (3, 64), (4, 65), (3, 127), (3, 128), (3, 129), (3, 192), (4, 243),
                   (3, 255), (2, 256))


def check_bwd_tiles(torch, gen, dt, name_dt):
    """K4 at its tiles' edges against its plain version (fp32 also against
    autograd through K3's plain version); deterministic: two calls give the
    same bits, and a sequence's d(qkv) is the same at R = 1 as inside R = 5
    (N = 17 and 243)."""
    from d3dp_tpu_torch.ops import attention as A

    tol = TOL_QKV[name_dt]
    ulp = BF16_ULP if dt == torch.bfloat16 else 0.0
    for R, N in BWD_TILE_SHAPES:
        qkv, dout = qkv_inputs(torch, gen, R, N, dt)
        got = A.fused_attention_qkv_bwd(qkv, dout, HEADS, 0.125)
        want = A.fused_attention_qkv_bwd_plain(qkv, dout, HEADS, 0.125)
        torch.cuda.synchronize()
        e, ex = max_err(torch, got, want, ulp)
        ea = ""
        if dt == torch.float32:
            leaf = qkv.clone().requires_grad_(True)
            (auto,) = torch.autograd.grad(A.fused_attention_qkv_plain(leaf, HEADS, 0.125), leaf,
                                          dout)
            e_a, ex_a = max_err(torch, got, auto, 0.0)
            ex = max(ex, ex_a)
            ea = f", vs autograd of the plain forward {e_a:.3e}"
        log(f"[kernels] fused_attention_qkv_bwd tile edge {name_dt} qkv{tuple(qkv.shape)}: "
            f"max|err| {e:.3e}{ea} (tol {tol:g}{' + 1 bf16 ulp' if ulp else ''}) "
            f"{'ok' if ex <= tol else 'FAIL'}")
        check(ex <= tol, f"fused_attention_qkv_bwd at N={N} {name_dt} disagrees with its "
                         "plain version")
    for N in (J, F):
        qkv, dout = qkv_inputs(torch, gen, 5, N, dt)
        a = A.fused_attention_qkv_bwd(qkv, dout, HEADS, 0.125)
        b = A.fused_attention_qkv_bwd(qkv, dout, HEADS, 0.125)
        one = A.fused_attention_qkv_bwd(qkv[2:3].contiguous(), dout[2:3].contiguous(), HEADS,
                                        0.125)
        torch.cuda.synchronize()
        ok = torch.equal(a, b) and torch.equal(one[0], a[2])
        log(f"[kernels] fused_attention_qkv_bwd {name_dt} N={N}: two calls equal "
            f"{torch.equal(a, b)}, a sequence at R = 1 equal to it inside R = 5 "
            f"{torch.equal(one[0], a[2])} {'ok' if ok else 'FAIL'}")
        check(ok, f"fused_attention_qkv_bwd at N={N} is not deterministic")


# (R, N) of 17, 63, 65, 127, 129 and 12,393 token rows: fewer than a stage
# tile of 64 rows (both dtypes; bf16's ln_qkv takes 128), one under and over
# one and two tiles, and 729 spatial sequences (41 rows in the last tile)
STAGE_TILE_SHAPES = ((1, 17), (7, 9), (5, 13), (127, 1), (3, 43), (729, 17))


def check_stage_tile_edges(torch, gen, dt, name_dt, errs):
    """The stage kernels on token-row counts around the GEMM walks' 64-row
    tiles: K1, K1-dp, K8, K1 under noy2 (x2 only) and K6 against their plain
    versions; K8 equal to K1 and noy2's x2 equal to K1's, bit for bit."""
    from d3dp_tpu_torch.ops import attention as A

    tol = TOL[name_dt]
    ulp = BF16_ULP if dt == torch.bfloat16 else 0.0
    scale = (C // HEADS) ** -0.5
    for R, N in STAGE_TILE_SHAPES:
        a = stage_inputs(torch, gen, R, N, dt)
        dp = dp_scales(torch, gen, (R,))
        hm = [a[0], *A.stack_head_major(a[1], a[2], HEADS), *a[3:]]
        b = block_inputs(torch, gen, R, N, dt)
        k1 = A.attention_stage(*a, HEADS, scale, 1e-6)
        k8 = A.attention_stage_hm(*hm, HEADS, scale, 1e-6)
        with env_var("D3DP_ATTN_VARIANT", "noy2"):
            noy2 = A.attention_stage(*a, HEADS, scale, 1e-6)[:1]
        pairs = (("attention_stage", k1, A.attention_stage_plain(*a, HEADS, scale, 1e-6)),
                 ("attention_stage_dp", A.attention_stage_dp(*a, dp, HEADS, scale, 1e-6),
                  A.attention_stage_dp_plain(*a, dp, HEADS, scale, 1e-6)),
                 ("attention_stage_hm", k8, A.attention_stage_hm_plain(*hm, HEADS, scale, 1e-6)),
                 ("attention_stage[noy2]", noy2, A.attention_stage_plain(
                     *a, HEADS, scale, 1e-6, opts=A.OPT_NO_Y2)[:1]),
                 ("attention_block", A.attention_block(*b, HEADS, scale, 1e-6),
                  A.attention_block_plain(*b, HEADS, scale, 1e-6)))
        torch.cuda.synchronize()
        for name, got, want in pairs:
            e = max(max_err(torch, g, w, ulp)[0] for g, w in zip(got, want))
            ex = max(max_err(torch, g, w, ulp)[1] for g, w in zip(got, want))
            log(f"[kernels] {name} tile edge {name_dt} ({R}, {N}) = {R * N} token rows: "
                f"max|err| {e:.3e} (tol {tol:g}{' + 1 bf16 ulp' if ulp else ''}) "
                f"{'ok' if ex <= tol else 'FAIL'}")
            check(ex <= tol, f"{name} on {R} x {N} {name_dt} disagrees with its plain version")
            if dt == torch.bfloat16:
                errs[name] = max(errs.get(name, 0.0), e)
        same = all(torch.equal(g, w) for g, w in zip(k8, k1)) and torch.equal(noy2[0], k1[0])
        log(f"[kernels] attention_stage_hm and noy2's x2 equal to attention_stage {name_dt} "
            f"({R}, {N}): {same}")
        check(same, f"K8 or noy2's x2 differs from K1 on {R} x {N} {name_dt}")
        del a, dp, hm, b, k1, k8, noy2, pairs


# The trunk kernel's first run: depth 1, 2 rows of 27 frames, both compute
# dtypes, in a child process. A grid barrier that some block never reaches
# would hang the launch; the child's time limit turns that into an error.
PROBE = """
import torch
from d3dp_tpu_torch import disable_tf32
from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig
from d3dp_tpu_torch.ops import resident as R
disable_tf32()
for dt in (torch.float32, torch.bfloat16):
    m = MixSTE2(MixSTEConfig(num_frames=27, depth=1, dtype=dt), seed=1)
    W = m._weights()
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(2, 27, 17, 512, generator=g, device="cuda").to(dt)
    args = (x, W["temporal_pos"][0], *W["resident"], 8, 0.125, 1e-6)
    got = R.resident_block_stack(*args).float()
    torch.cuda.synchronize()
    want = R.resident_block_stack_plain(*args).float()
    d = (got - want).abs()
    ulp = 0.0 if dt == torch.float32 else 2.0 ** -7
    print(f"{str(dt)[6:]} max|err| {d.max().item():.3e}", flush=True)
    assert (d - ulp * want.abs()).max().item() <= (1e-4 if dt == torch.float32 else 3e-2)
# bf16 under the switches K9 reads, against the plain version with the same options
import os
for name, value in (("D3DP_SOFTMAX_FOLD", "0"), ("D3DP_ATTN_VARIANT", "bf16exp"),
                    ("D3DP_MLP_VARIANT", "bf16gelu"), ("D3DP_MLP_VARIANT", "nogelu")):
    os.environ[name] = value
    opts, gelu = R.resident_options(dt)
    got = R.resident_block_stack(*args).float()
    torch.cuda.synchronize()
    want = R.resident_block_stack_plain(*args, opts=opts, gelu=gelu).float()
    d = (got - want).abs()
    print(f"{name}={value} bf16 max|err| {d.max().item():.3e}", flush=True)
    assert (d - ulp * want.abs()).max().item() <= 3e-2
    del os.environ[name]
"""


def probe_resident(torch):
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                           timeout=180)
    except subprocess.TimeoutExpired:
        raise RuntimeError("resident_block_stack: the depth-1 probe did not finish in 180 s "
                           "(a grid barrier that not every block reaches?)") from None
    ok = r.returncode == 0
    log(f"[kernels] resident_block_stack depth-1 probe (child process, 180 s limit): "
        f"{' / '.join(r.stdout.strip().splitlines())} in {time.perf_counter() - t0:.1f} s "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"resident_block_stack probe failed:\n{r.stderr[-3000:]}")


def resident_inputs(torch, dt, seed, rows=ROWS):
    """K9's operands as the main path gives them: the embedded (rows, F, J,
    C) stream of a seeded, perturbed full-width MixSTE2 (depth 8) and that
    model's depth-stacked weights."""
    from d3dp_tpu_torch.models import MixSTE2

    model = MixSTE2(dataclasses.replace(main_config(torch).model, dtype=dt), seed=seed)
    perturb_(torch, model, seed + 1)
    W = model._weights()
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    x2d = torch.randn(rows, F, J, 2, generator=g, device="cuda") * 0.3
    x3d = torch.randn(rows, F, J, 3, generator=g, device="cuda")
    t = torch.randint(0, 1000, (rows,), generator=g, device="cuda")
    with torch.no_grad():
        x = model._embed(x2d, x3d, t, W)
    return (x, W["temporal_pos"][0], *W["resident"])


# K9 in bf16 at depth 8: its relative L2 distance from the fp32 math of the
# same bf16 inputs may exceed the plain version's by at most this factor
BF16_CHAIN_RATIO = 1.05


def check_resident_kernel(torch, dt, name_dt, errs):
    """K9 against its plain version on the eval path's 40 rows.
    fp32, depth 8: 1e-4 (summation order only). bf16, depth 1 (one block
    pair): K1/K2's tolerance, 3e-2 plus one bf16 ulp of the value. bf16,
    depth 8: the rounding flips of 16 chained blocks compound on both
    sides, so the two bf16 versions drift apart by several ulps; held
    instead to be no further from the fp32 math of the same bf16 inputs
    than the plain version is (relative L2, factor BF16_CHAIN_RATIO), with
    the max |kernel - plain| reported."""
    from d3dp_tpu_torch.ops import resident as R

    x, tpos, sp, tp, shared = resident_inputs(torch, dt, 30)
    depths = (DEPTH,) if dt == torch.float32 else (1, DEPTH)
    for D in depths:
        args = (x, tpos, tuple(w[:D] for w in sp), tuple(w[:D] for w in tp), shared)
        got = R.resident_block_stack(*args, HEADS, 0.125, 1e-6)
        want = R.resident_block_stack_plain(*args, HEADS, 0.125, 1e-6)
        torch.cuda.synchronize()
        ok = bool(torch.isfinite(got).all())
        if dt == torch.float32 or D == 1:
            ulp = BF16_ULP if dt == torch.bfloat16 else 0.0
            tol = TOL[name_dt]
            e, ex = max_err(torch, got, want, ulp)
            ok = ok and ex <= tol
            how = f"tol {tol:g}{' + 1 bf16 ulp' if ulp else ''}"
        else:
            e = (got.float() - want.float()).abs().max().item()
            f32 = (x.float(), tpos, tuple(w[:D].float() for w in sp),
                   tuple(w[:D].float() for w in tp), shared)
            ref = R.resident_block_stack_plain(*f32, HEADS, 0.125, 1e-6)
            rel_k = ((got.float() - ref).norm() / ref.norm()).item()
            rel_p = ((want.float() - ref).norm() / ref.norm()).item()
            ok = ok and rel_k <= BF16_CHAIN_RATIO * rel_p
            how = (f"relative L2 from the fp32 math: kernel {rel_k:.4e}, plain {rel_p:.4e}, "
                   f"tol {BF16_CHAIN_RATIO:g}x plain")
            del ref
        log(f"[kernels] resident_block_stack {name_dt} x{tuple(x.shape)} depth {D}: "
            f"max|err| {e:.3e} ({how}) {'ok' if ok else 'FAIL'}")
        check(ok, f"resident_block_stack {name_dt} depth {D} disagrees with its plain version")
        if dt == torch.bfloat16:
            errs["resident_block_stack"] = max(errs["resident_block_stack"], e)
        del got, want


def check_3dhp_rows(torch, gen, dt, name_dt, errs, rows=ROWS_3DHP, tag="3DHP"):
    """K1 and K2 against their plain versions at the 3DHP evaluation's 80
    hypothesis rows (19,440 spatial sequences of 17 tokens, 1,360 temporal
    ones of 243; 330,480 token rows through the MLP), at K1/K2's tolerance;
    then K9 at depth 2 on those rows, in `group_rows`' grouping for them,
    against the level-4 chain of K1 and K2 launches: equal bit for bit.
    `rows` and `tag`: another row count (phase dp's 20 a rank)."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M
    from d3dp_tpu_torch.ops import resident as R

    ulp = BF16_ULP if dt == torch.bfloat16 else 0.0
    tol = TOL[name_dt]
    for label, Rn, N in (("spatial", rows * F, J), ("temporal", rows * J, F)):
        args = stage_inputs(torch, gen, Rn, N, dt)
        got = A.attention_stage(*args, HEADS, (C // HEADS) ** -0.5, 1e-6)
        want = A.attention_stage_plain(*args, HEADS, (C // HEADS) ** -0.5, 1e-6)
        torch.cuda.synchronize()
        es = [max_err(torch, g, w, ulp) for g, w in zip(got, want)]
        ok = all(ex <= tol for _, ex in es)
        log(f"[kernels] attention_stage {tag} {label} {name_dt} x{tuple(args[0].shape)}: "
            f"max|err| x2 {es[0][0]:.3e} y2 {es[1][0]:.3e} (tol {tol:g}"
            f"{' + 1 bf16 ulp' if ulp else ''}) {'ok' if ok else 'FAIL'}")
        check(ok, f"attention_stage at the {tag} rows ({label}, {name_dt}) disagrees with its "
                  "plain version")
        if dt == torch.bfloat16:
            errs["attention_stage"] = max(errs["attention_stage"], *(e for e, _ in es))
        del args, got, want
    for label, D1, D2 in (("spatial->temporal", F, J), ("temporal->spatial", J, F)):
        args = mlp_inputs(torch, gen, D1, D2, dt, rows=rows)
        got = M.mlp_block_t(*args, 1e-6)
        want = M.mlp_block_t_plain(*args, 1e-6)
        torch.cuda.synchronize()
        e, ex = max_err(torch, got, want, ulp)
        log(f"[kernels] mlp_block_t {tag} {label} {name_dt} x{tuple(args[0].shape)}: max|err| "
            f"{e:.3e} (tol {tol:g}{' + 1 bf16 ulp' if ulp else ''}) {'ok' if ex <= tol else 'FAIL'}")
        check(ex <= tol, f"mlp_block_t at the {tag} rows ({label}, {name_dt}) disagrees with its "
                         "plain version")
        if dt == torch.bfloat16:
            errs["mlp_block_t"] = max(errs["mlp_block_t"], e)
        del args, got, want
    x, tpos, sp, tp, shared = resident_inputs(torch, dt, 60, rows=rows)
    args = (x, tpos, tuple(w[:2] for w in sp), tuple(w[:2] for w in tp), shared)
    groups = R.group_rows(rows, F, J, torch.cuda.get_device_properties(0).multi_processor_count)
    got = R.resident_block_stack(*args, HEADS, 0.125, 1e-6)
    want = level4_chain(R, A, M, args)
    torch.cuda.synchronize()
    equal = torch.equal(got, want) and bool(torch.isfinite(got).all())
    log(f"[kernels] resident_block_stack {tag} {name_dt} x{tuple(x.shape)} depth 2, {groups} "
        f"rows a group: max|diff| to the level-4 chain "
        f"{(got.float() - want.float()).abs().max().item():.3e}, equal {equal} "
        f"{'ok' if equal else 'FAIL'}")
    check(equal, f"resident_block_stack at the {tag} rows ({name_dt}) differs from level 4")
    del x, args, got, want


def block_inputs(torch, gen, R, N, dt):
    """K6's operands: unit-normal packed qkv, a residual of 0.5, a 0.05
    projection."""
    def rn(*shape, s=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * s

    return [rn(R, N, 3 * C).to(dt), rn(R, N, C, s=0.5).to(dt), rn(C, C, s=0.05).to(dt),
            rn(C, s=0.02), 1 + rn(C, s=0.1), rn(C, s=0.1)]


def packed_inputs(torch, gen, R, N, dt):
    """K7's operands: unit-normal q, k, v, each (R, N, C)."""
    return [torch.randn(R, N, C, generator=gen, device="cuda").to(dt) for _ in range(3)]


def check_eval_kernels(torch, gen, dt, name_dt, errs):
    """K5 (MLP rows), K6 (attention block), K7 (packed attention) and K1's
    attend launch alone against their plain versions at the eval path's
    shapes: K5 on the 165,240 token rows of one block, the others at the
    spatial and temporal stage shapes. Tolerance: K5 and K6 as K2 and K1
    (3e-2), K7 and attend as K3 (1e-2), each plus one bf16 ulp in bf16."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M

    ulp = BF16_ULP if dt == torch.bfloat16 else 0.0
    tol = TOL[name_dt]
    args = mlp_inputs(torch, gen, F, J, dt)
    args[:2] = [a.view(-1, C) for a in args[:2]]
    cases = [("mlp_block", f"rows{tuple(args[0].shape)}", tol,
              lambda: (M.mlp_block(*args, 1e-6),), lambda: (M.mlp_block_plain(*args, 1e-6),))]
    for label, R, N in (("spatial", ROWS * F, J), ("temporal", ROWS * J, F)):
        b = block_inputs(torch, gen, R, N, dt)
        p = packed_inputs(torch, gen, R, N, dt)
        cases += [
            ("attention_block", f"{label} qkv{tuple(b[0].shape)}", tol,
             lambda b=b: A.attention_block(*b, HEADS, 0.125, 1e-6),
             lambda b=b: A.attention_block_plain(*b, HEADS, 0.125, 1e-6)),
            ("fused_attention_packed", f"{label} q{tuple(p[0].shape)}", TOL_QKV[name_dt],
             lambda p=p: (A.fused_attention_packed(*p, HEADS, 0.125),),
             lambda p=p: (A.fused_attention_plain(*p, HEADS, 0.125),)),
            # K1's attend launch alone (the tile every attention kernel runs)
            ("attend_qkv", f"{label} qkv{tuple(b[0].shape)}", TOL_QKV[name_dt],
             lambda b=b: (A.attend_qkv(b[0], HEADS, 0.125),),
             lambda b=b: (A.attend_qkv_plain(b[0], HEADS, 0.125),))]
    for name, label, tol_k, run, plain in cases:
        got, want = run(), plain()
        torch.cuda.synchronize()
        es = [max_err(torch, g, w, ulp) for g, w in zip(got, want)]
        ok = all(ex <= tol_k for _, ex in es)
        log(f"[kernels] {name} {label} {name_dt}: max|err| "
            f"{' / '.join(f'{e:.3e}' for e, _ in es)} (tol {tol_k:g}"
            f"{' + 1 bf16 ulp' if ulp else ''}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {label} {name_dt} disagrees with its plain version")
        if dt == torch.bfloat16:
            errs[name] = max(errs.get(name, 0.0), *(e for e, _ in es))
        del got, want


def dp_scales(torch, gen, shape, keep=0.9):
    """DropPath branch scales as the model draws them: 1/keep where kept, 0
    where dropped, at least one of each."""
    u = torch.rand(shape, generator=gen, device="cuda")
    m = torch.where(u < keep, 1.0 / keep, 0.0)
    m.view(-1)[0], m.view(-1)[-1] = 0.0, 1.0 / keep
    return m


# the stage and MLP shapes of the eval path (40 hypothesis rows) and of the
# train step (4 chunks): (label, R, N) and (label, rows, D1, D2)
STAGE_SHAPES = (("eval spatial", ROWS * F, J), ("eval temporal", ROWS * J, F),
                ("train spatial", BT * F, J), ("train temporal", BT * J, F))
MLP_SHAPES = (("eval spatial->temporal", ROWS, F, J), ("eval temporal->spatial", ROWS, J, F),
              ("train spatial->temporal", BT, F, J), ("train temporal->spatial", BT, J, F))


def check_train_fused_kernels(torch, gen, dt, name_dt, errs):
    """The DropPath forms of K1, K2 and K5 and the head-major stage K8
    against their plain versions, at the eval and the train shapes, with
    scales of 0 and 1/keep; K8 also against K1 on the same inputs (the same
    products in the same order: equal bit for bit). Tolerance as K1/K2's."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M

    ulp = BF16_ULP if dt == torch.bfloat16 else 0.0
    tol = TOL[name_dt]
    how = f"tol {tol:g}{' + 1 bf16 ulp' if ulp else ''}"

    def compare(name, label, got, want):
        es = [max_err(torch, g, w, ulp) for g, w in zip(got, want)]
        ok = all(ex <= tol for _, ex in es)
        log(f"[kernels] {name} {label} {name_dt}: max|err| "
            f"{' / '.join(f'{e:.3e}' for e, _ in es)} ({how}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {label} {name_dt} disagrees with its plain version")
        if dt == torch.bfloat16:
            errs[name] = max(errs[name], *(e for e, _ in es))

    for label, R, N in STAGE_SHAPES:
        args = stage_inputs(torch, gen, R, N, dt)
        dp = dp_scales(torch, gen, (R,))
        compare("attention_stage_dp", f"{label} x{(R, N, C)}",
                A.attention_stage_dp(*args, dp, HEADS, 0.125, 1e-6),
                A.attention_stage_dp_plain(*args, dp, HEADS, 0.125, 1e-6))
        hm = [args[0], *A.stack_head_major(args[1], args[2], HEADS), *args[3:]]
        got = A.attention_stage_hm(*hm, HEADS, 0.125, 1e-6)
        compare("attention_stage_hm", f"{label} x{(R, N, C)}", got,
                A.attention_stage_hm_plain(*hm, HEADS, 0.125, 1e-6))
        k1 = A.attention_stage(*args, HEADS, 0.125, 1e-6)
        torch.cuda.synchronize()
        diff = max((g.float() - k.float()).abs().max().item() for g, k in zip(got, k1))
        equal = all(torch.equal(g, k) for g, k in zip(got, k1))
        log(f"[kernels] attention_stage_hm vs attention_stage {label} {name_dt}: max|diff| "
            f"{diff:.3e}, equal {equal} {'ok' if equal else 'FAIL'}")
        check(equal, f"attention_stage_hm {label} {name_dt} differs from attention_stage")
        del args, dp, hm, got, k1
    for label, rows, D1, D2 in MLP_SHAPES:
        args = mlp_inputs(torch, gen, D1, D2, dt, rows)
        dp = dp_scales(torch, gen, (rows, D1))
        compare("mlp_block_t_dp", f"{label} x{(rows, D1, D2, C)}",
                (M.mlp_block_t_dp(*args, dp, 1e-6),), (M.mlp_block_t_dp_plain(*args, dp, 1e-6),))
        if label.endswith("spatial->temporal"):
            r = [a.view(-1, C) for a in args[:2]] + args[2:]
            dpr = dp_scales(torch, gen, (r[0].shape[0],))
            compare("mlp_block_dp", f"{label.split()[0]} rows{tuple(r[0].shape)}",
                    (M.mlp_block_dp(*r, dpr, 1e-6),), (M.mlp_block_dp_plain(*r, dpr, 1e-6),))
            del r, dpr
        del args, dp


def check_backwards(torch, record):
    """Each autograd Function of the train-fused path (kernel forward,
    plain-op backward around K3 and K4) against torch.autograd through its
    plain forward, fp32 at the train shapes: every gradient within 1e-3
    relative in norm (summation order only)."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M

    gen = torch.Generator(device="cuda").manual_seed(13)
    f32 = torch.float32
    worst = {}

    def run(name, label, fused, plain, args, out_shapes):
        cts = [torch.randn(sh, generator=gen, device="cuda") for sh in out_shapes]
        grads = []
        for fn in (fused, plain):
            leaves = [a.clone().requires_grad_(True) for a in args]
            o = fn(*leaves)
            grads.append(torch.autograd.grad(o if isinstance(o, tuple) else (o,), leaves, cts))
        torch.cuda.synchronize()
        rel = max(((g - w).norm() / w.norm()).item() for g, w in zip(*grads))
        ok = rel <= 1e-3
        log(f"[backward] {name} {label} fp32: worst gradient rel {rel:.2e} of {len(args)} "
            f"(tol 1e-3) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {label}: backward disagrees with autograd of the plain forward")
        worst[name] = max(worst.get(name, 0.0), rel)

    for label, R, N in TRAIN_SHAPES:
        args = stage_inputs(torch, gen, R, N, f32)
        dp = dp_scales(torch, gen, (R,))
        outs = [(R, N, C)] * 2
        run("attention_stage_ad", label, lambda *a: A.attention_stage_ad(*a, HEADS, 0.125, 1e-6),
            lambda *a: A.attention_stage_plain(*a, HEADS, 0.125, 1e-6), args, outs)
        run("attention_stage_dp_ad", label,
            lambda *a: A.attention_stage_dp_ad(*a, dp, HEADS, 0.125, 1e-6),
            lambda *a: A.attention_stage_dp_plain(*a, dp, HEADS, 0.125, 1e-6), args, outs)
        run("attention_block_ad", label, lambda *a: A.attention_block_ad(*a, HEADS, 0.125, 1e-6),
            lambda *a: A.attention_block_plain(*a, HEADS, 0.125, 1e-6),
            block_inputs(torch, gen, R, N, f32), outs)
    for label, D1, D2 in (("spatial->temporal", F, J), ("temporal->spatial", J, F)):
        args = mlp_inputs(torch, gen, D1, D2, f32, BT)
        dp = dp_scales(torch, gen, (BT, D1))
        outs = [(BT, D2, D1, C)]
        run("mlp_block_t_ad", label, lambda *a: M.mlp_block_t_ad(*a, 1e-6),
            lambda *a: M.mlp_block_t_plain(*a, 1e-6), args, outs)
        run("mlp_block_t_dp_ad", label, lambda *a: M.mlp_block_t_dp_ad(*a, dp, 1e-6),
            lambda *a: M.mlp_block_t_dp_plain(*a, dp, 1e-6), args, outs)
        if label == "spatial->temporal":
            r = [a.view(-1, C) for a in args[:2]] + args[2:]
            dpr = dp_scales(torch, gen, (r[0].shape[0],))
            outs = [tuple(r[0].shape)]
            run("mlp_block_ad", "rows", lambda *a: M.mlp_block_ad(*a, 1e-6),
                lambda *a: M.mlp_block_plain(*a, 1e-6), r, outs)
            run("mlp_block_dp_ad", "rows", lambda *a: M.mlp_block_dp_ad(*a, dpr, 1e-6),
                lambda *a: M.mlp_block_dp_plain(*a, dpr, 1e-6), r, outs)
    record["backward_max_rel_err"] = worst


def phase_model(torch, record):
    """MixSTE2, fp32, full width, depth 2: kernel path vs plain path."""
    from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig

    model = MixSTE2(MixSTEConfig(num_frames=F, embed_dim=C, depth=2), seed=5)
    perturb_(torch, model, 6)
    g = torch.Generator(device="cuda").manual_seed(7)
    x2d = torch.randn(2, F, J, 2, generator=g, device="cuda") * 0.3
    x3d = torch.randn(2, F, J, 3, generator=g, device="cuda")
    t = torch.tensor([999, 17], device="cuda", dtype=torch.int32)
    with torch.no_grad():
        out = model(x2d, x3d, t)
        with plain_ops():
            ref = model(x2d, x3d, t)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    ok = out.shape == (2, F, J, 3) and bool(torch.isfinite(out).all()) and err <= 1e-4
    log(f"[model] MixSTE2 fp32 C={C} depth 2 B=2: kernel vs plain max|err| {err:.3e} "
        f"(tol 1e-4) {'ok' if ok else 'FAIL'}")
    check(ok, "MixSTE2 kernel path disagrees with the plain path")
    record["model_fp32_max_abs_err"] = err


# the kernels of each fuse level, each launched once per block (2*depth a
# forward) at levels 0-4 and once per forward at level 5; every other
# kernel launches 0 times
LEVEL_KERNELS = {0: ("fused_attention_qkv",), 1: ("fused_attention_qkv", "mlp_block"),
                 2: ("attention_block", "mlp_block"), 3: ("attention_block", "mlp_block_t"),
                 4: ("attention_stage", "mlp_block_t"), 5: ("resident_block_stack",)}


def per_forward(level):
    return 1 if level == 5 else 2 * DEPTH


def set_level(model, level):
    """The same weights on another rung of the fuse-level ladder."""
    model.cfg = dataclasses.replace(model.cfg, fuse_level=level)


def phase_fuse_levels(torch, record, d3dp, x2d, x2d_f):
    """MixSTE2 fp32, full width, depth 2, on two windows and on one (where
    the relayouts between the stages are views): levels 0-3 and 5 against
    level 4 and against the plain path (1e-4, fp32 summation order only); then one
    bf16 D3DP.sample at the eval config per level, its launch counts, its
    time (median of 3 CUDA-event timings after a warm-up call) and, at
    levels 0-3, its device time by kernel (level 5's: phase resident)."""
    from torch.profiler import ProfilerActivity, profile

    from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig

    model = MixSTE2(MixSTEConfig(num_frames=F, embed_dim=C, depth=2), seed=5)
    perturb_(torch, model, 6)
    g = torch.Generator(device="cuda").manual_seed(7)
    xa = torch.randn(2, F, J, 2, generator=g, device="cuda") * 0.3
    xb = torch.randn(2, F, J, 3, generator=g, device="cuda")
    t = torch.tensor([999, 17], device="cuda", dtype=torch.int32)
    errs = {}
    with torch.no_grad():
        for n in (2, 1):
            args = (xa[:n], xb[:n], t[:n])
            set_level(model, 4)
            ref = model(*args)
            for level in (0, 1, 2, 3, 5):
                set_level(model, level)
                out = model(*args)
                with plain_ops():
                    plain = model(*args)
                torch.cuda.synchronize()
                e = ((out - ref).abs().max().item(), (out - plain).abs().max().item())
                errs[level if n == 2 else f"{level} one window"] = e
                ok = bool(torch.isfinite(out).all()) and max(e) <= 1e-4
                log(f"[fuse-levels] MixSTE2 fp32 C={C} depth 2 B={n} level {level}: max|err| vs "
                    f"level 4 {e[0]:.3e}, vs plain {e[1]:.3e} (tol 1e-4) {'ok' if ok else 'FAIL'}")
                check(ok, f"MixSTE2 on {n} windows at fuse level {level} disagrees with level 4 "
                          f"or the plain path")
    del model

    rows = {}
    for level in range(6):
        per_call = per_forward(level) * K
        set_level(d3dp.model, level)
        g = torch.Generator(device="cuda").manual_seed(10 + level)
        reset_counts()
        preds = d3dp.sample(x2d, x2d_f, generator=g)
        torch.cuda.synchronize()
        counts = read_counts()
        want = {n: per_call if n in LEVEL_KERNELS[level] else 0 for n in counts}
        ok = counts == want and bool(torch.isfinite(preds).all())
        sample_ms = time_ms(torch, lambda: d3dp.sample(x2d, x2d_f, generator=g), reps=3)
        rows[level] = dict(sample_s=sample_ms / 1e3,
                           hyp_frames_per_s=B * H * F * K * 1e3 / sample_ms,
                           launches={n: c for n, c in counts.items() if c})
        log(f"[fuse-levels] D3DP.sample B={B} H={H} K={K} F={F} bf16 flip-TTA at level {level}: "
            f"{sample_ms / 1e3:.4f} s/call (median of 3), {rows[level]['hyp_frames_per_s']:.1f} "
            f"hyp*frames/s; launches {rows[level]['launches']} (expected {per_call} of "
            f"{', '.join(LEVEL_KERNELS[level])}) {'ok' if ok else 'FAIL'}")
        check(ok, f"D3DP.sample at fuse level {level}: launch counts or non-finite output")
        if level < 4:  # level 4's breakdown is phase profile's
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                d3dp.sample(x2d, x2d_f, generator=g)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            rows[level]["profile"] = summarize_profile(
                torch, prof, wall_ms, f"one D3DP.sample call at level {level}",
                f"fuse-levels-profile L{level}", top=8)
    set_level(d3dp.model, 4)
    record["fuse_levels"] = dict(model_fp32_max_abs_err=errs, sample=rows)


def load_test_module(name):
    """tests/<name>.py of this checkout, loaded from its file (on the chip
    machine another `tests` package on the path shadows the repo's)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"chip_smoke_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TRUTH_LIMIT = 0.5e-4  # a contraction's distance from float64: half the fp32 band
TRUTH_MM = 3.1e-4  # PERF.md section 2: the modes' allowance over twice the yardstick's gap
# The composed fp32 train step's block linears on the tf32x3 GEMM
# (`ops.linear`): (name, in, out) of each nn.Linear; its forward is x @ W^T
# over K = in, its input gradient dY @ W over K = out, on M = 4 x 243 x 17
# token rows (16,524 = 129 x 128 + 12: a ragged last tile), and at two
# small ragged row counts
LINEAR_SHAPES = (("qkv", 512, 1536), ("proj", 512, 512), ("fc1", 512, 1024),
                 ("fc2", 1024, 512))
LINEAR_ROWS = (BT * F * J, 17, 129)


def log_contractions(tag, readings):
    for name, r in readings.items():
        log(f"[fp32-truth] {tag} {name} K={r['K']} (max|out| {r['out']:.3f}): max|kernel - "
            f"float64| {r['kernel']:.3e}, max|plain fp32 (TF32 off) - float64| "
            f"{r['plain']:.3e}")


def capture_blocks(model, args, calls):
    """The stage input h and the weights w of the model's blocks `calls` (0,
    1: depth 0's spatial and temporal blocks; ...) in one forward on args
    at levels 1-4."""
    seen = []
    block = model._block

    def recorder(w, blk, h, out_norm, B):
        seen.append((w, h))
        return block(w, blk, h, out_norm, B)

    model._block = recorder
    try:
        model(*args)
    finally:
        del model._block
    return {i: seen[i] for i in calls}


def linear_rows(torch, reps=20):
    """The tf32x3 GEMM of the block linears (`ops.linear.gemm`) at each
    LINEAR_SHAPES product, forward (B = W, with its bias) and input
    gradient (B = W^T), each at the LINEAR_ROWS row counts: its error from
    float64 (max |diff| over the output's largest magnitude) against
    cuBLAS's fp32 product on the same inputs (TF32 off: FFMA), which it must
    not pass twice; the split kernel's planes equal `ops.tf32.planes` bit
    for bit. Timed at the train step's rows: the GEMM, cuBLAS's product
    (F.linear's forward, dY @ W), the three-pass bound and the FMA figure,
    and the split of each weight into both orientations' planes."""
    import torch.nn.functional as Fn

    from d3dp_tpu_torch.ops import linear as L
    from d3dp_tpu_torch.ops import tf32

    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 products are on")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, fails = [], []

    def rel(got, want):
        return ((got.double() - want).abs().max() / want.abs().max()).item()

    for name, k_in, n_out in LINEAR_SHAPES:
        w = torch.randn(n_out, k_in, generator=gen, device="cuda") * 0.02  # the init's std
        bias = torch.randn(n_out, generator=gen, device="cuda") * 0.02
        p, pt = L.split_planes(w, transposed=True)
        equal = torch.equal(p, tf32.planes(w.t())) and torch.equal(pt, tf32.planes(w))
        if not equal:
            fails.append(f"{name}: the split kernel's planes differ from ops.tf32.planes")
        split_ms = time_ms(torch, lambda: L.split_planes(w, transposed=True), reps)
        split_bound = 1e3 * 20 * w.numel() / HBM  # 4 bytes read, 16 written a weight
        log(f"[linear] {name} split ({n_out}x{k_in}, both orientations): {split_ms:.4f} ms, "
            f"bound {split_bound:.4f} ms (bytes); planes equal ops.tf32.planes: {equal}")
        for orient in ("forward", "input gradient"):
            fwd = orient == "forward"
            K, N = (k_in, n_out) if fwd else (n_out, k_in)
            planes, b = (p, bias) if fwd else (pt, None)
            B = w if fwd else w.t().contiguous()
            for M in LINEAR_ROWS:
                # LayerNorm-like rows forward, gradient-like rows backward
                a = torch.randn(M, K, generator=gen, device="cuda") * (1.0 if fwd else 1e-3)
                want = a.double() @ B.double().t() + (0 if b is None else b.double())
                got = L.gemm(a, planes, b)
                lib = Fn.linear(a, w, b) if fwd else a @ w
                e_k, e_l = rel(got, want), rel(lib, want)
                ok = e_k <= 2 * e_l
                row = dict(name=name, orient=orient, M=M, N=N, K=K, err=e_k, cublas_err=e_l,
                           ok=ok)
                if M == LINEAR_ROWS[0]:
                    flops = 2 * M * N * K
                    row.update(
                        ms=time_ms(torch, lambda: L.gemm(a, planes, b), reps),
                        cublas_ms=time_ms(torch, (lambda: Fn.linear(a, w, b)) if fwd else
                                          (lambda: a @ w), reps),
                        bound_ms=1e3 * max(3 * flops / PEAK_TF32, 4 * (M * K + M * N) / HBM),
                        fma_ms=1e3 * flops / PEAK_FP32_FMA, split_ms=split_ms,
                        plain_ms=time_ms(torch, lambda: L.gemm_plain(a, planes, b), 2))
                    row["speedup"] = row["cublas_ms"] / row["ms"]
                    row["roofline"] = 100 * row["bound_ms"] / row["ms"]
                    log(f"[linear] {name} {orient} M={M} N={N} K={K}: {row['ms']:.4f} ms "
                        f"({row['roofline']:.1f}% of the three-pass bound {row['bound_ms']:.4f}"
                        f" ms), cuBLAS fp32 {row['cublas_ms']:.4f} ms ({row['speedup']:.2f}x), "
                        f"FMA figure {row['fma_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms")
                log(f"[linear] {name} {orient} M={M}: error {e_k:.3e} of the output's largest,"
                    f" cuBLAS fp32 {e_l:.3e} {'ok' if ok else 'FAIL'}")
                if not ok:
                    fails.append(f"{name} {orient} M={M}: error {e_k:.3e} > 2 x cuBLAS {e_l:.3e}")
                rows.append(row)
    timed = [r for r in rows if "ms" in r]
    total = {k: sum(r[k] for r in timed) for k in ("ms", "cublas_ms", "bound_ms")}
    log(f"[linear] the eight products at {LINEAR_ROWS[0]} rows: {total['ms']:.3f} ms, cuBLAS "
        f"{total['cublas_ms']:.3f} ms ({total['cublas_ms'] / total['ms']:.2f}x), bound "
        f"{total['bound_ms']:.3f} ms ({100 * total['bound_ms'] / total['ms']:.1f}%)")
    return dict(rows=rows, total=total), fails


def phase_fp32_truth(torch, record):
    """fp32 against float64 on the card (module docstring, fp32_truth).
    (a) Each contraction of the fp32 walks at its whole K, read through the
    partial forms' walks (`utils/fp32_accuracy.py`): o @ Wp (K1's, K6's,
    K8's and K9's projection walk), fc1 and fc2 (K2's, K5's and K9's MLP
    walk), at the card tests' inputs (tests/test_torch_kernels.py's
    `_stage_inputs(rng, 64, 17, 512)` and `_mlp_inputs(rng, 64, 17, 1, 512,
    1024)` from np.random.RandomState(0): 1,088 token rows) and at the
    activations that the full-width model feeds its depth-0 and depth-7
    blocks in one level-4 forward; the whole forms K1 (x2, y2), K2 and K5
    at the card tests' inputs against the same functions in float64. Each
    contraction at the card tests' inputs must sit within TRUTH_LIMIT of
    float64, each whole form within the fp32 band (1e-4). (b) fp32
    `D3DP.sample` at levels 4 and 5 on one window (H=5, K=5, flip-TTA,
    injected noise) against tests/fp64_truth.py's `sample` in float64 on
    the card, the same weights and noise, beside the plain fp32
    composition (TF32 off): the predictions' max |diff| and the four modes'
    gap (`fp64_truth.score`); the kernel path's must stay within twice the
    plain composition's, the modes' within twice plus TRUTH_MM."""
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT
    from d3dp_tpu_torch.diffusion import D3DP
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M
    from d3dp_tpu_torch.ops import resident as R
    from d3dp_tpu_torch.utils.fp32_accuracy import contraction_errors

    T = load_test_module("fp64_truth")
    kt = load_test_module("test_torch_kernels")
    out, fails = {}, []

    def hold(ok, msg):  # every reading is printed before the phase fails
        if not ok:
            fails.append(msg)

    # (a) the card tests' inputs
    rng = np.random.RandomState(0)
    s = [torch.from_numpy(v).cuda() for v in kt._stage_inputs(rng, 64, J, C)]
    m = [torch.from_numpy(v).cuda() for v in kt._mlp_inputs(rng, 64, J, 1, C, HIDDEN)]
    x, wqkv, bqkv, wp, bp, l1s, l1b, l2s, l2b = s
    x64 = x.double()
    qkv = (T.layer_norm(x64, l1s.double(), l1b.double(), 1e-6) @ wqkv.double()
           + bqkv.double()).float()
    card = contraction_errors(qkv, wp, m[0].view(-1, C), m[2], m[3], m[4], HEADS, 0.125)
    log_contractions("card tests' inputs (1,088 rows)", card)
    for name, r in card.items():
        ok = math.isfinite(r["kernel"]) and r["kernel"] <= TRUTH_LIMIT
        log(f"[fp32-truth] card tests' inputs {name}: limit {TRUTH_LIMIT:g} "
            f"{'ok' if ok else 'FAIL'}")
        hold(ok, f"fp32 {name} walk {r['kernel']:.3e} from float64 at the card tests' inputs")
    out["card_inputs"] = card

    # the whole forms there, against the same functions in float64
    P = {"a.qkv.weight": wqkv.t().double(), "a.qkv.bias": bqkv.double(),
         "a.proj.weight": wp.t().double(), "a.proj.bias": bp.double()}
    x2_64 = x64 + T.attention(P, "a", T.layer_norm(x64, l1s.double(), l1b.double(), 1e-6),
                              HEADS, 0.125)
    y2_64 = T.layer_norm(x2_64, l2s.double(), l2b.double(), 1e-6)
    xm, res, w1, b1, w2, b2, lns, lnb = m
    z = res.double() + (T.gelu(xm.double() @ w1.double() + b1.double()) @ w2.double()
                        + b2.double())
    mlp64 = T.layer_norm(z, lns.double(), lnb.double(), 1e-6)  # (64, 17, 1, C)
    forms = {
        "K1 attention_stage": ((x2_64, y2_64), lambda: A.attention_stage(*s, HEADS, 0.125, 1e-6),
                               lambda: A.attention_stage_plain(*s, HEADS, 0.125, 1e-6)),
        "K2 mlp_block_t": ((mlp64.transpose(1, 2),), lambda: (M.mlp_block_t(*m, 1e-6),),
                           lambda: (M.mlp_block_t_plain(*m, 1e-6),)),
        "K5 mlp_block": ((mlp64.view(-1, C),),
                         lambda: (M.mlp_block(xm.view(-1, C), res.view(-1, C), *m[2:], 1e-6),),
                         lambda: (M.mlp_block_plain(xm.view(-1, C), res.view(-1, C), *m[2:],
                                                    1e-6),))}
    whole = {}
    for name, (want, kernel, plain) in forms.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        ek = [(g.double() - w).abs().max().item() for g, w in zip(got, want)]
        ep = [(g.double() - w).abs().max().item() for g, w in zip(ref, want)]
        ok = all(math.isfinite(e) and e <= TOL["float32"] for e in ek)
        whole[name] = dict(kernel=ek, plain=ep)
        log(f"[fp32-truth] card tests' inputs, whole form {name}: max|kernel - float64| "
            f"{' / '.join(f'{e:.3e}' for e in ek)}, max|plain fp32 (TF32 off) - float64| "
            f"{' / '.join(f'{e:.3e}' for e in ep)} (limit {TOL['float32']:g}) "
            f"{'ok' if ok else 'FAIL'}")
        hold(ok, f"fp32 {name} farther than {TOL['float32']:g} from float64")
    out["whole_forms"] = whole
    del s, m, x64, qkv, P, x2_64, y2_64, z, mlp64, forms

    # (b)'s model and window; (a) at its activations
    cfg = main_config(torch)
    d3dp = D3DP(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=torch.float32)), seed=0)
    perturb_(torch, d3dp.model, 1)
    model = d3dp.model
    rng = np.random.RandomState(21)
    x3d = (rng.randn(1, F, J, 3) * 0.15).astype(np.float32)
    x3d[:, :, 0] = 0.0
    traj = (np.array([0.1, -0.1, 5.0]) + rng.randn(1, F, 1, 3) * 0.05).astype(np.float32)
    cam = np.array([[1.1450, 1.1441, 0.0009, 0.0276, -0.2071, 0.2476, -0.0031, -0.0009,
                     -0.0014]], dtype=np.float32)
    perm = T.lr_perm(J, JOINTS_LEFT, JOINTS_RIGHT).cuda()
    x2d = T.project_to_2d(T.f64(x3d + traj), T.f64(cam)).float().cuda()
    x2d_f = T.flip_pose(x2d, perm)
    img0 = torch.from_numpy(rng.randn(1, H, F, J, 3).astype(np.float32)).cuda()
    steps = torch.from_numpy(rng.randn(K, 1, H, F, J, 3).astype(np.float32)).cuda()
    gt = tuple(T.f64(v).cuda() for v in (x2d, x3d, traj, cam))

    set_level(model, 4)
    rows = 2 * H
    args = (torch.cat([x2d.expand(H, -1, -1, -1), x2d_f.expand(H, -1, -1, -1)]),
            torch.cat([img0[0], T.flip_pose(img0[0], perm)]).clamp(-1.1, 1.1),
            torch.full((rows,), 999, device="cuda"))
    acts = {}
    sc = model.cfg.attn_scale
    with torch.no_grad():
        blocks = capture_blocks(model, args, (0, 1, 2 * DEPTH - 2, 2 * DEPTH - 1))
        for i, (w, h) in blocks.items():
            q = (T.layer_norm(h.double(), w["ln1s"].double(), w["ln1b"].double(), 1e-6)
                 @ w["wqkv"].double() + w["bqkv"].double()).float()
            _, y2 = A.attention_stage(h, *(w[k] for k in ("wqkv", "bqkv", "wp", "bp", "ln1s",
                                                          "ln1b", "ln2s", "ln2b")),
                                      HEADS, sc, 1e-6, planes=w["planes"]["stage"])
            tag = f"{'spatial' if i % 2 == 0 else 'temporal'} depth {i // 2}"
            acts[tag] = contraction_errors(q, w["wp"], y2.reshape(-1, C), w["w1"], w["b1"],
                                           w["w2"], HEADS, sc)
            log_contractions(f"model activations, {tag} ({h.shape[0] * h.shape[1]:,} rows)",
                             acts[tag])
            hold(all(math.isfinite(r["kernel"]) for r in acts[tag].values()),
                 f"non-finite fp32 walk reading at the model's {tag} activations")
    out["model_activations"] = acts
    del args, blocks

    # (b) D3DP.sample at levels 4 and 5 and the plain composition
    truth = T.sample(T.weights64(model.state_dict()), dict(depth=DEPTH, num_heads=HEADS),
                     x2d, x2d_f, img0, steps, perm)
    truth_modes, truth_sel = T.score(truth, *gt)

    def distance(preds):
        """(max |diff| of the predictions, the four modes' largest gap), mm,
        and the details: each mode's gap, the rms |diff|, the selections
        that differ from the truth's (P-Best's a step, JPMA's a joint) and
        the modes' gap on the truth's selections."""
        diff = preds.double() - truth
        diff[..., 0, :] = 0.0  # the root, zeroed before scoring
        modes, sel = T.score(preds, *gt)
        on_truth, _ = T.score(preds, *gt, selections=truth_sel)
        gaps = {k: float(np.abs(modes[k] - truth_modes[k]).max() * 1e3) for k in T.MODES}
        return diff.abs().max().item() * 1e3, max(gaps.values()), dict(
            mode_gaps_mm=gaps, pred_rms_mm=diff.square().mean().sqrt().item() * 1e3,
            flips={k: int((sel[k] != truth_sel[k]).sum()) for k in sel},
            gap_truth_selections_mm=float(max(np.abs(on_truth[k] - truth_modes[k]).max()
                                              for k in T.MODES) * 1e3))

    paths, preds = {}, {}
    for level in (4, 5):
        set_level(model, level)
        reset_counts()
        preds[level] = d3dp.sample(x2d, x2d_f, noise_override=(img0, steps))
        torch.cuda.synchronize()
        n = (R.resident_block_stack.launches if level == 5
             else A.attention_stage.launches + M.mlp_block_t.launches)
        want = K if level == 5 else 2 * 2 * DEPTH * K
        hold(n == want, f"fp32 sample at level {level}: {n} launches, expected {want}")
        paths[f"level {level}"] = distance(preds[level])
    set_level(model, 4)
    with plain_ops():
        paths["plain"] = distance(d3dp.sample(x2d, x2d_f, noise_override=(img0, steps)))
    equal = torch.equal(preds[4], preds[5])
    pe, pg, _ = paths["plain"]
    for name, (e, g, more) in paths.items():
        ok = name == "plain" or (e <= 2 * pe and g <= 2 * pg + TRUTH_MM and equal)
        log(f"[fp32-truth] D3DP.sample B=1 H={H} K={K} F={F} fp32 flip-TTA, {name}: predictions "
            f"max|diff| {e:.4e} mm, four modes' gap {g:.4e} mm from fp64_truth.sample"
            + ("" if name == "plain" else f" (limits {2 * pe:.4e} mm, {2 * pg + TRUTH_MM:.4e} mm;"
               f" level 5 equal to level 4 {equal}) {'ok' if ok else 'FAIL'}"))
        log(f"[fp32-truth]   {name}: " + json.dumps(more))
        hold(ok, f"fp32 sample, {name}: farther from the float64 truth than the rule allows")
    out["sample"] = {k: dict(pred_max_mm=e, modes_gap_mm=g, **more)
                     for k, (e, g, more) in paths.items()}
    out["truth_modes_mm"] = {k: (v * 1e3).tolist() for k, v in truth_modes.items()}
    out["linear"], linear_fails = linear_rows(torch)
    fails += linear_fails
    record["fp32_truth"] = out
    del d3dp, model, preds, truth
    check(not fails, "phase fp32_truth: " + "; ".join(fails))
    return out


def resident_flops_bytes(x, D):
    """K9's work at its inputs: the operations of 2*D blocks (qkv, proj,
    MLP and attention products) and the bytes of the stream in and out,
    the depth-stacked weights, tpos and the shared norms, each once."""
    Bx, Fx, Jx, Cx = x.shape
    T, item = Bx * Fx * Jx, x.element_size()
    blk = 2 * T * Cx * 3 * Cx + 2 * T * Cx * Cx + 4 * T * Cx * HIDDEN
    flops = D * (2 * blk + 4 * T * Cx * (Jx + Fx))
    nbytes = (2 * T * Cx * item + 2 * D * (4 * Cx * Cx + 2 * Cx * HIDDEN) * item
              + 2 * D * (3 * Cx + HIDDEN + 6 * Cx) * 4 + Fx * Cx * item + 4 * Cx * 4)
    return flops, nbytes


def library_trunk(torch, Fn, x, tpos, spatial, temporal, shared, act=True):
    """The trunk in library calls in x's dtype (K9's yardstick): per depth
    and kind layer_norm, F.linear, SDPA on q/k/v views, F.linear, the
    residual, layer_norm, F.linear, GELU (without act: none), F.linear, the
    residual and the shared layer_norm, with the relayouts as copies.
    Weights are re-laid out for F.linear here, outside the timed call."""
    bf = x.dtype
    D = spatial[0].shape[0]

    def prep(ws):
        wqkv, bqkv, wp, w1, b1, w2, vec = ws
        return [(wqkv[d].t().contiguous(), bqkv[d, 0].to(bf), wp[d].t().contiguous(),
                 w1[d].t().contiguous(), b1[d, 0].to(bf), w2[d].t().contiguous(),
                 [v.to(bf) for v in vec[d]]) for d in range(D)]

    sp, tp, sh = prep(spatial), prep(temporal), [v.to(bf) for v in shared]
    tp_bf = tpos.to(bf)

    def block(h, w, ns, nb):
        wqkv, bqkv, wp, w1, b1, w2, (bp, l1s, l1b, l2s, l2b, b2) = w
        R, N, _ = h.shape
        qkv = Fn.linear(Fn.layer_norm(h, (C,), l1s, l1b, 1e-6), wqkv, bqkv)
        q, k, v = qkv.view(R, N, 3, HEADS, C // HEADS).permute(2, 0, 3, 1, 4).unbind(0)
        o = Fn.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(R, N, C)
        x2 = h + Fn.linear(o, wp, bp)
        h1 = Fn.linear(Fn.layer_norm(x2, (C,), l2s, l2b, 1e-6), w1, b1)
        m = Fn.linear(Fn.gelu(h1) if act else h1, w2, b2)
        return Fn.layer_norm(x2 + m, (C,), ns, nb, 1e-6)

    def run():
        Bx, Fx, Jx, _ = x.shape
        h = x.reshape(Bx * Fx, Jx, C)
        for d in range(D):
            h = block(h, sp[d], sh[0], sh[1]).view(Bx, Fx, Jx, C).transpose(1, 2)
            h = h.reshape(Bx * Jx, Fx, C)
            if d == 0:
                h = h + tp_bf
            h = block(h, tp[d], sh[2], sh[3]).view(Bx, Jx, Fx, C).transpose(1, 2)
            h = h.reshape(Bx * Fx, Jx, C)
        return h
    return run


def phase_resident(torch, record, d3dp, x2d, x2d_f, rows):
    """Fuse level 5 on the main path's model (bf16, depth 8, 40 rows; fp32
    level 5 against level 4 is phase fuse_levels', at depth 2): level 5
    against level 4 on the same weights and inputs (exactly equal: the same
    device code and roundings), with the forward's launch counts; one
    profiled D3DP.sample at level 5 (K launches of K9; its unprofiled time
    is phase fuse_levels'); one timed D3DP.sample with feature reuse
    (interval 2, tap 2: level 4's kernels, 56 launches each at depth 8);
    K9's time per launch against its bound, its plain version and the
    library yardstick."""
    from torch.profiler import ProfilerActivity, profile

    import torch.nn.functional as Fn
    from d3dp_tpu_torch.diffusion import D3DP
    from d3dp_tpu_torch.ops import resident as R

    out = {}
    g = torch.Generator(device="cuda").manual_seed(40)
    xa = torch.randn(ROWS, F, J, 2, generator=g, device="cuda") * 0.3
    xb = torch.randn(ROWS, F, J, 3, generator=g, device="cuda")
    t = torch.randint(0, 1000, (ROWS,), generator=g, device="cuda")
    res, counts = {}, {}
    for level in (4, 5):
        set_level(d3dp.model, level)
        reset_counts()
        res[level] = d3dp.model(xa, xb, t)
        torch.cuda.synchronize()
        counts[level] = {n: c for n, c in read_counts().items() if c}
    diff = (res[5].float() - res[4].float()).abs().max().item()
    equal = torch.equal(res[5], res[4]) and bool(torch.isfinite(res[5]).all())
    want = {5: {"resident_block_stack": 1},
            4: {"attention_stage": 2 * DEPTH, "mlp_block_t": 2 * DEPTH}}
    ok = equal and counts == want
    log(f"[resident] MixSTE2 bf16 C={C} depth {DEPTH} {ROWS} rows: level 5 vs level 4 max|diff| "
        f"{diff:.3e}, equal {equal}; launches per forward {counts} {'ok' if ok else 'FAIL'}")
    check(ok, "level 5 differs from level 4, or launch counts")
    out["level5_vs_level4_bf16"] = diff
    del res

    # the level-5 main path: one sample call, counted and profiled
    set_level(d3dp.model, 5)
    g = torch.Generator(device="cuda").manual_seed(41)
    reset_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        preds = d3dp.sample(x2d, x2d_f, generator=g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    counts = {n: c for n, c in read_counts().items() if c}
    ok = counts == {"resident_block_stack": K} and bool(torch.isfinite(preds).all())
    log(f"[resident] D3DP.sample B={B} H={H} K={K} F={F} bf16 flip-TTA at level 5 (profiled): "
        f"launches {counts} (expected {K} of resident_block_stack) {'ok' if ok else 'FAIL'}")
    check(ok, "D3DP.sample at level 5: launch counts or non-finite output")
    record["launches"]["resident_block_stack"] = counts.get("resident_block_stack", 0)
    out["profile"] = summarize_profile(torch, prof, wall_ms, "one D3DP.sample call at level 5",
                                       "resident-profile", top=6)

    reuse = D3DP(dataclasses.replace(d3dp.cfg, reuse_interval=2, reuse_tap=2), model=d3dp.model)
    want = {n: 3 * 2 * DEPTH + 2 * 2 * 2 for n in LEVEL_KERNELS[4]}
    reset_counts()
    preds = reuse.sample(x2d, x2d_f, generator=g)
    torch.cuda.synchronize()
    counts = {n: c for n, c in read_counts().items() if c}
    ok = counts == want and bool(torch.isfinite(preds).all()) and \
        tuple(preds.shape) == (B, K, H, F, J, 3)
    sample_ms = time_ms(torch, lambda: reuse.sample(x2d, x2d_f, generator=g), reps=3)
    out["reuse"] = dict(sample_s=sample_ms / 1e3, launches=counts,
                        hyp_frames_per_s=B * H * F * K * 1e3 / sample_ms)
    log(f"[resident] D3DP.sample B={B} H={H} K={K} F={F} bf16 flip-TTA at level 5 + reuse "
        f"interval 2 tap 2: {sample_ms / 1e3:.4f} s/call (median of 3), "
        f"{out['reuse']['hyp_frames_per_s']:.1f} hyp*frames/s; launches {counts} "
        f"(expected {want}) {'ok' if ok else 'FAIL'}")
    check(ok, "D3DP.sample with reuse: launch counts, shape or non-finite output")
    set_level(d3dp.model, 4)

    args = resident_inputs(torch, torch.bfloat16, 30)
    flops, nbytes = resident_flops_bytes(args[0], DEPTH)
    lib = library_trunk(torch, Fn, *args)
    row = dict(shape=list(args[0].shape), flops=flops, bytes=nbytes,
               ms=time_ms(torch, lambda: R.resident_block_stack(*args, HEADS, 0.125, 1e-6),
                          reps=5),
               plain_ms=time_ms(torch, lambda: R.resident_block_stack_plain(
                   *args, HEADS, 0.125, 1e-6), reps=2),
               library_ms=time_ms(torch, lib, reps=5))
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, PEAK_BF16)
    log(f"[resident] resident_block_stack bf16 x{tuple(args[0].shape)} depth {DEPTH}: kernel "
        f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
        f"{flops / 1e12:.3f} TFLOP, {nbytes / 1e9:.3f} GB), plain {row['plain_ms']:.4f} ms, "
        f"library {row['library_ms']:.4f} ms, {flops / row['ms'] / 1e9:.1f} TFLOP/s")
    rows["resident_block_stack/trunk"] = row
    out["phase_clocks"] = resident_phase_split(torch, args, row["ms"])
    del args, lib
    out["trunk_fp32"] = resident_row_fp32(torch, Fn)
    record["resident"] = out


def resident_row_fp32(torch, Fn):
    """K9 in fp32 at the eval shape (40 rows, depth 8) on the matrices' TF32
    planes, made outside the timed call as the weight cache makes them,
    against its bound at the three-pass TF32 rate, the FMA figure, its
    plain version and the library trunk in fp32 (TF32 off)."""
    from d3dp_tpu_torch.ops import resident as R
    from d3dp_tpu_torch.ops import tf32

    args = resident_inputs(torch, torch.float32, 30)
    planes = tuple(tuple(tf32.planes(kind[i]) for i in (0, 2, 3, 5)) for kind in args[2:4])
    flops, nbytes = resident_flops_bytes(args[0], DEPTH)
    lib = library_trunk(torch, Fn, *args)
    row = dict(shape=list(args[0].shape), flops=flops, bytes=nbytes,
               ms=time_ms(torch, lambda: R.resident_block_stack(*args, HEADS, 0.125, 1e-6,
                                                                planes=planes), reps=3),
               plain_ms=time_ms(torch, lambda: R.resident_block_stack_plain(
                   *args, HEADS, 0.125, 1e-6), reps=2),
               library_ms=time_ms(torch, lib, reps=3), fma_ms=1e3 * flops / PEAK_FP32_FMA)
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, PEAK_TF32 / 3)
    log(f"[resident] resident_block_stack fp32 x{tuple(args[0].shape)} depth {DEPTH}: kernel "
        f"{row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}, three TF32 "
        f"passes; FMA figure {row['fma_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, library "
        f"(TF32 off) {row['library_ms']:.4f} ms, {flops / row['ms'] / 1e9:.1f} TFLOP/s")
    return row


def resident_phase_split(torch, args, k9_ms):
    """K9's time by phase at the eval shape, from the build with per-phase
    clocks: each phase's mean cycles a block spends in its tiles and waiting
    at the grid barrier after them, as shares of all of them and as ms of
    the kernel's event-timed k9_ms; with the rows grouped by `group_rows`,
    and one row a group (the grouping the L2 rule gave at this shape)."""
    from d3dp_tpu_torch.ops import resident as R

    out = {}
    for tag, group in (("grouped", None), ("one row a group", 1)):
        sums = R.resident_phase_clocks(*args, HEADS, 0.125, 1e-6, group=group)
        total = sum(w + b for w, b in sums.values())
        split = {p: dict(tiles=w / total, barrier=b / total) for p, (w, b) in sums.items()}
        scale = k9_ms if group is None else None
        out[tag] = dict(shares=split, k9_ms=scale,
                        barrier_share=sum(v["barrier"] for v in split.values()),
                        spatial_attend_cycles=sums["spatial attend"])
        w, b = sums["spatial attend"]
        log(f"[resident] K9 spatial attend phase ({tag}): {w} cycles in its tiles, {b} at "
            f"its barrier (summed over blocks), {split['spatial attend']['tiles']:.4f} + "
            f"{split['spatial attend']['barrier']:.4f} of the launch"
            + (f", {(w + b) / total * scale:.3f} ms" if scale else ""))
        log(f"[resident] K9 phase clocks, {tag} ({'G = group_rows' if group is None else 'G = 1'}"
            f"): barrier share {out[tag]['barrier_share']:.4f}; " + "; ".join(
                f"{p} {v['tiles']:.4f} + {v['barrier']:.4f}"
                + (f" ({(v['tiles'] + v['barrier']) * scale:.3f} ms)" if scale else "")
                for p, v in split.items()))
    return out


def phase_packed(torch, record):
    """The packed-attention op (K7) has no caller on the model's paths; its
    path is its public (B, N, h, d) wrapper `fused_attention`, called once at
    each stage shape of the eval path."""
    from d3dp_tpu_torch.ops import attention as A

    gen = torch.Generator(device="cuda").manual_seed(12)
    reset_counts()
    for R, N in ((ROWS * F, J), (ROWS * J, F)):
        q, k, v = (t.view(R, N, HEADS, C // HEADS)
                   for t in packed_inputs(torch, gen, R, N, torch.bfloat16))
        out = A.fused_attention(q, k, v, 0.125)
        check(tuple(out.shape) == (R, N, HEADS, C // HEADS) and bool(torch.isfinite(out).all()),
              "fused_attention: wrong shape or non-finite output")
    torch.cuda.synchronize()
    n = read_counts()["fused_attention_packed"]
    log(f"[packed] fused_attention (B, N, h, d) bf16 at both stage shapes: launches {n} "
        f"(expected 2) {'ok' if n == 2 else 'FAIL'}")
    check(n == 2, "fused_attention did not launch its kernel")
    record["launches"]["fused_attention_packed"] = n


def report_lines(path):
    """({mode: [mm per step]} of the action-wise averages under Protocol 1,
    the same under Protocol 2, the file's lines) from an h36m_test_log
    file."""
    out = {"1": {}, "2": {}}
    pat = re.compile(r"step (\d+) Protocol #(\d) +\(MPJPE\) action-wise average (\w+): (\S+) mm")
    lines = open(path).read().splitlines()
    for line in lines:
        m = pat.match(line)
        if m:
            out[m.group(2)].setdefault(m.group(3), []).append(float(m.group(4)))
    return out["1"], out["2"], lines


def phase_cli(torch, record):
    """The H36M command line in process, at the published width with the
    synthetic dataset: one training epoch with checkpoints, a resumed
    second epoch, then `--evaluate best_epoch.ckpt` (H=5, K=5) at every
    fuse level, and at level 4 with DDIM feature reuse (`--ddim-reuse 2
    --ddim-reuse-tap 2`: steps 0, 2 and 4 run all 8 block pairs, steps 1
    and 3 the first 2), and at level 4 with `--p2-device` (Protocol-2 on the
    device: 4 x K more action-wise lines, Protocol-1 equal to the level-4
    run's). Every report line must be a finite number and J-Best <= P-Best. Checkpoints go to a directory under log/ (git-ignored) that is
    removed afterwards; the command line's output goes to
    chiprun_out/chip_smoke_cli.log."""
    from d3dp_tpu_torch.cli import main_h36m

    ckdir = os.path.join("log", "chip_smoke_cli")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    # --dp 1: the one-process path, whose launches this process counts (the
    # command lines take every card by default)
    base = ["-d", "synthetic", "--nolog", "-cs", str(C), "-dep", str(DEPTH), "-f", str(F),
            "--dtype", "bfloat16", "-c", ckdir, "--eval-batch-size", str(B), "--dp", "1"]
    # 6 test sequences of 400 synthetic frames: 2 windows each, 1 micro-batch
    n_batches = 2 * 3 * math.ceil(math.ceil(400 / F) / B)
    runs = [("train", ["-e", "1", "-cf", "1"], None),
            ("resume", ["-r", "epoch_1.ckpt", "-e", "2", "-cf", "1"], None)]
    evaluate = ["--evaluate", "best_epoch.ckpt", "-num_proposals", str(H), "-sampling_timesteps",
                str(K)]
    runs += [(f"eval L{level}", evaluate + ["--fuse-level", str(level)],
              {n: n_batches * per_forward(level) * K for n in LEVEL_KERNELS[level]})
             for level in range(6)]
    # reuse: 3 full steps of 2*depth blocks and 2 steps of 2*tap blocks
    runs.append(("eval L4 reuse", evaluate + ["--fuse-level", "4", "--ddim-reuse", "2",
                                              "--ddim-reuse-tap", "2"],
                 {n: n_batches * (3 * 2 * DEPTH + 2 * 2 * 2) for n in LEVEL_KERNELS[4]}))
    runs.append(("eval L4 p2-device", evaluate + ["--fuse-level", "4", "--p2-device"],
                 {n: n_batches * per_forward(4) * K for n in LEVEL_KERNELS[4]}))
    out = {}
    try:
        with open(os.path.join("chiprun_out", "chip_smoke_cli.log"), "w") as f:
            for name, extra, want in runs:
                reset_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(f):
                    print(f"==== {name}: {' '.join(base + extra)}", flush=True)
                    main_h36m.main(base + extra)
                torch.cuda.synchronize()
                counts = {n: c for n, c in read_counts().items() if c}
                out[name] = dict(seconds=time.perf_counter() - t0, launches=counts)
                if want is not None:
                    logf = os.path.join(ckdir, f"h36m_test_log_H{H}_K{K}.txt")
                    avg, avg2, lines = report_lines(logf)
                    os.replace(logf, os.path.join(ckdir, name.replace(" ", "_") + ".txt"))
                    nums = [float(x) for line in lines
                            for x in re.findall(r": (\S+) mm$", line)]
                    finite = len(nums) == len(lines) - 3 * 2 and all(map(math.isfinite, nums))
                    jbest = all(j <= p + 1e-9 for j, p in zip(avg["J_Best"], avg["P_Best"]))
                    ok = finite and jbest and len(avg["P_Best"]) == K and counts == want
                    if "--p2-device" in extra:
                        # P2's action-wise lines, and P1 as the run without it
                        ok = ok and sum(map(len, avg2.values())) == 4 * K and \
                            avg == out["eval L4"]["action_avg_mm"]
                        out[name].update(action_avg_p2_mm=avg2)
                    else:
                        ok = ok and not avg2
                    out[name].update(action_avg_mm={m: v for m, v in avg.items()})
                    log(f"[cli] {name}: {out[name]['seconds']:.1f} s, {len(nums)} report numbers "
                        f"finite {finite}, J-Best <= P-Best {jbest}, last-step P1 action-wise "
                        + ", ".join(f"{m} {v[-1]:.2f}" for m, v in avg.items())
                        + (", P2 " + ", ".join(f"{m} {v[-1]:.2f}" for m, v in avg2.items())
                           if avg2 else "")
                        + f" mm; launches {counts} (expected {want}) {'ok' if ok else 'FAIL'}")
                    check(ok, f"command line {name}: report lines or launch counts")
                else:
                    ck = "best_epoch.ckpt" if name == "train" else "epoch_2.ckpt"
                    epoch_lines = [line for line in open(os.path.join(
                        ckdir, "training_log.txt")).read().splitlines() if line.startswith("[")]
                    ok = os.path.exists(os.path.join(ckdir, ck)) and \
                        counts.get("fused_attention_qkv_bwd", 0) > 0 and \
                        len(epoch_lines) == (1 if name == "train" else 2)
                    log(f"[cli] {name}: {out[name]['seconds']:.1f} s, {ck} written, launches "
                        f"{counts}; training log: {epoch_lines[-1] if epoch_lines else ''} "
                        f"{'ok' if ok else 'FAIL'}")
                    check(ok, f"command line {name}: no checkpoint, epoch line or backward")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    record["cli"] = out
    record["launches"]["mlp_block"] = sum(out[f"eval L{lv}"]["launches"].get("mlp_block", 0)
                                          for lv in (1, 2))
    record["launches"]["attention_block"] = sum(
        out[f"eval L{lv}"]["launches"].get("attention_block", 0) for lv in (2, 3))


def phase_host(torch, record):
    """The host side of training (phase host): ChunkedGenerator over
    synthetic data at the train config's batch (BT chunks of F frames)
    takes the native (C++) chunk assembler (asserted: the box has g++), its
    epoch byte-identical to the numpy path's, each path's ms a batch beside
    phase train's step, and the assembler's g++ build timed; then the H36M
    command line in process at the published width, depth cut to 2 (the
    checkpoint a quarter of depth 8's), with `--ckpt-format orbax
    --input-pipeline grain` (grain runs the default Prefetcher): one
    training epoch, whose epoch_1.orbax (a DCP directory, written
    asynchronously) loads to the weights of the same epoch run with the
    default flags (pickle), whose training log line it repeats (losses
    within 1e-4 relative), then `-r auto` resuming from it for a second
    epoch, which writes epoch_2.orbax. Under log/chip_smoke_host (removed
    afterwards); the command line's output to
    chiprun_out/chip_smoke_host.log."""
    import tempfile
    from pathlib import Path

    from d3dp_tpu_torch.cli import main_h36m
    from d3dp_tpu_torch.data import native
    from d3dp_tpu_torch.data.generators import ChunkedGenerator
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT, make_dataset
    from d3dp_tpu_torch.train import checkpoint_io

    t_phase = time.perf_counter()
    lr_kw = dict(kps_left=list(JOINTS_LEFT), kps_right=list(JOINTS_RIGHT),
                 joints_left=list(JOINTS_LEFT), joints_right=list(JOINTS_RIGHT))
    # 90 windows of 243 frames, twice with flip augmentation: 45 batches
    data = make_dataset(seed=5, lengths=(6000, 4500, 7500, 3500))

    def gen(use_native):
        return ChunkedGenerator(BT, *data, F, shuffle=True, random_seed=1234, augment=True,
                                pad_last=True, use_native=use_native, **lr_kw)
    nat, npy = gen(True), gen(False)
    batch_ms, epochs = {}, {}
    for name, g in (("native", nat), ("numpy", npy)):
        list(g.next_epoch())  # warm
        t0 = time.perf_counter()
        epochs[name] = list(g.next_epoch())
        batch_ms[name] = (time.perf_counter() - t0) * 1e3 / len(epochs[name])
    a, b = epochs["native"], epochs["numpy"]
    same = len(a) == len(b) and all(np.asarray(x).tobytes() == np.asarray(y).tobytes()
                                    for ba, bb in zip(a, b) for x, y in zip(ba, bb))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        native._build(Path(tmp) / "libchunk_assembler.so")
        build_s = time.perf_counter() - t0
    step_ms = record["train"]["step_s"] * 1e3
    ok = nat.assembler == "native" and npy.assembler == "numpy" and same
    log(f"[host] ChunkedGenerator (use_native=True) took the {nat.assembler} path; "
        f"{len(a)} batches of {BT}x{F} frames, ms a batch: native {batch_ms['native']:.4f}, "
        f"numpy {batch_ms['numpy']:.4f} (a train step, phase train: {step_ms:.1f} ms; the "
        f"Prefetcher's worker assembles behind it); the assembler's g++ build {build_s:.2f} s; "
        f"native and numpy byte-identical {same} {'ok' if ok else 'FAIL'}")
    check(ok, "phase host: the native assembler did not run or the batches differ")

    root = os.path.join("log", "chip_smoke_host")
    shutil.rmtree(root, ignore_errors=True)
    base = ["-d", "synthetic", "--nolog", "-cs", str(C), "-dep", "2", "-f", str(F),
            "--dtype", "bfloat16", "--eval-batch-size", str(B), "--dp", "1", "-cf", "1"]
    new = ["--ckpt-format", "orbax", "--input-pipeline", "grain"]
    runs = (("default flags", "default", ["-e", "1"]), ("orbax + grain", "new", ["-e", "1"] + new),
            ("orbax + grain resumed", "new", ["-e", "2", "-r", "auto"] + new))
    out = {}
    try:
        with open(os.path.join("chiprun_out", "chip_smoke_host.log"), "w") as f:
            for name, sub, extra in runs:
                ckdir = os.path.join(root, sub)
                os.makedirs(ckdir, exist_ok=True)
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(f):
                    print(f"==== {name}: {' '.join(base + extra)}", flush=True)
                    main_h36m.main(base + ["-c", ckdir] + extra)
                torch.cuda.synchronize()
                with open(os.path.join(ckdir, "training_log.txt")) as lf:
                    lines = [line for line in lf.read().splitlines() if line.startswith("[")]
                out[name] = dict(seconds=time.perf_counter() - t0, log=lines)
        nums = [[float(v) for v in re.findall(r"(?:3d_train|3d_pos_valid) ([\d.]+)",
                                              out[n]["log"][0])]
                for n in ("default flags", "orbax + grain")]
        losses_ok = len(nums[0]) == len(nums[1]) > 0 and all(
            abs(x - y) <= 1e-4 * abs(y) for x, y in zip(*nums))
        orbax1 = os.path.join(root, "new", "epoch_1.orbax")
        got = checkpoint_io.load_any(orbax1)
        want = checkpoint_io.load_any(os.path.join(root, "default", "epoch_1.ckpt"))
        gap = max((got["model"][k].float() - v.float()).abs().max().item()
                  for k, v in want["model"].items())
        resumed = out["orbax + grain resumed"]["log"]
        ok = (losses_ok and os.path.isdir(orbax1) and got["epoch"] == 1
              and got["random_state"] is not None and got["optimizer"] is not None
              and len(resumed) == 2 and resumed[1].startswith("[2] ")
              and os.path.isdir(os.path.join(root, "new", "epoch_2.orbax"))
              and not os.path.exists(os.path.join(root, "new", "epoch_2.ckpt")))
        log(f"[host] command line --ckpt-format orbax --input-pipeline grain: epoch "
            f"{out['orbax + grain']['seconds']:.1f} s against {out['default flags']['seconds']:.1f}"
            f" s with the default flags; training log {out['orbax + grain']['log'][0]!r} against "
            f"{out['default flags']['log'][0]!r} (1e-4 relative: {losses_ok}); epoch_1.orbax's "
            f"weights against epoch_1.ckpt's max|diff| {gap:.3e}; resumed: "
            f"{resumed[-1] if resumed else None!r} {'ok' if ok else 'FAIL'}")
        check(ok, "phase host: the orbax/grain command line disagrees or did not resume")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record["host"] = dict(assembler=nat.assembler, batch_ms=batch_ms, build_s=build_s,
                          cli={k: v["seconds"] for k, v in out.items()}, weight_gap=gap,
                          seconds=time.perf_counter() - t_phase)
    log(f"[host] phase host: {record['host']['seconds']:.1f} s")


def write_3dhp_annotations(directory, data, frames):
    """TS*/annot_data.mat for the PCK/AUC tables, from the synthetic test
    sequences: annot3 (3, 17, frames) absolute poses in mm (the stored
    sequences keep the root trajectory in joint 14, the other joints
    relative to it), their valid masks, and seeded activity labels 1-7."""
    import scipy.io as sio

    from d3dp_tpu_torch.data.mpi3dhp import ROOT_JOINT

    _, _, p3_test, _, valid = data
    rs = np.random.RandomState(0)
    for key, p3 in p3_test.items():
        gt = p3.copy()
        root = gt[:, ROOT_JOINT : ROOT_JOINT + 1]
        gt[:, :ROOT_JOINT] += root
        gt[:, ROOT_JOINT + 1 :] += root
        os.makedirs(os.path.join(directory, key))
        sio.savemat(os.path.join(directory, key, "annot_data.mat"),
                    {"annot3": gt.transpose(2, 1, 0), "valid_frame": valid[key],
                     "activity_annotation": rs.randint(1, 8, frames)})


def phase_cli_3dhp(torch, record):
    """The MPI-INF-3DHP command line in process at the published width, bf16,
    on its synthetic data (4 training and 2 test sequences, TS1 and TS2, of
    600 frames): one training epoch with checkpoints, a resumed epoch, then
    `--evaluate best_epoch.ckpt` at the 3DHP evaluation config (H=20, K=10,
    2 windows a micro-batch: 80 hypothesis rows, 2 x 2 micro-batches) at
    fuse levels 4 and 5 from the same seed. Each run is timed, and each
    evaluation's seconds per micro-batch taken from Evaluator3DHP.evaluate's
    wall time (the .mat exports included). Held: every log number finite;
    the four exports (3, 17, 600, 10) per sequence; level 5's exports and
    log lines equal to level 4's bit for bit; exact launch counts; and the
    PCK/AUC tables of the level-4 exports against annotations written from
    the same synthetic test data, with finite MPJPE, PCK and AUC at every
    step. Checkpoints and exports go to a directory under log/ (git-ignored)
    that is removed afterwards; the command line's output goes to
    chiprun_out/chip_smoke_cli_3dhp.log."""
    import scipy.io as sio

    from d3dp_tpu_torch.cli import main_3dhp
    from d3dp_tpu_torch.data.mpi3dhp import make_synthetic
    from d3dp_tpu_torch.eval.evaluator_3dhp import MODES
    from d3dp_tpu_torch.metrics.pck_auc import evaluate_3dhp_mat

    frames, seed = 600, 1
    ckdir = os.path.join("log", "chip_smoke_cli_3dhp")
    shutil.rmtree(ckdir, ignore_errors=True)
    os.makedirs(ckdir)
    base = ["-d", "synthetic", "--nolog", "-cs", str(C), "-dep", str(DEPTH), "-f", str(F),
            "--dtype", "bfloat16", "-c", ckdir, "--synthetic-frames", str(frames),
            "--seed", str(seed), "--dp", "1"]  # one process, as phase cli
    n_batches = 2 * math.ceil(math.ceil(frames / F) / B_3DHP)
    evaluate = ["--evaluate", "best_epoch.ckpt", "-num_proposals", str(H_3DHP),
                "-sampling_timesteps", str(K_3DHP), "--eval-batch-size", str(B_3DHP)]
    runs = [("train", ["-e", "1", "-cf", "1"], None),
            ("resume", ["-r", "epoch_1.ckpt", "-e", "2", "-cf", "1"], None)]
    runs += [(f"eval L{level}", evaluate + ["--fuse-level", str(level)],
              {n: n_batches * per_forward(level) * K_3DHP for n in LEVEL_KERNELS[level]})
             for level in (4, 5)]
    evaluate_s = []
    real_evaluate = main_3dhp.Evaluator3DHP.evaluate

    def timed_evaluate(self, *a, **k):
        t0 = time.perf_counter()
        try:
            return real_evaluate(self, *a, **k)
        finally:
            evaluate_s.append(time.perf_counter() - t0)

    out = {}
    log_name = f"3dhp_test_log_H{H_3DHP}_K{K_3DHP}.txt"
    try:
        main_3dhp.Evaluator3DHP.evaluate = timed_evaluate
        with open(os.path.join("chiprun_out", "chip_smoke_cli_3dhp.log"), "w") as f:
            for name, extra, want in runs:
                reset_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(f):
                    print(f"==== {name}: {' '.join(base + extra)}", flush=True)
                    main_3dhp.main(base + extra)
                torch.cuda.synchronize()
                counts = {n: c for n, c in read_counts().items() if c}
                out[name] = dict(seconds=time.perf_counter() - t0, launches=counts,
                                 evaluate_s=evaluate_s[-1])
                if want is None:
                    ck = "best_epoch.ckpt" if name == "train" else "epoch_2.ckpt"
                    epoch_lines = [line for line in open(os.path.join(
                        ckdir, "training_log.txt")).read().splitlines() if line.startswith("[")]
                    nums = [float(x) for x in re.findall(r" (\S+)", epoch_lines[-1])[1::2]]
                    ok = os.path.exists(os.path.join(ckdir, ck)) and \
                        counts.get("fused_attention_qkv_bwd", 0) > 0 and \
                        len(epoch_lines) == (1 if name == "train" else 2) and \
                        all(map(math.isfinite, nums))
                    log(f"[cli-3dhp] {name}: {out[name]['seconds']:.1f} s (validation "
                        f"{evaluate_s[-1]:.2f} s), {ck} written, launches {counts}; training "
                        f"log: {epoch_lines[-1]} {'ok' if ok else 'FAIL'}")
                    check(ok, f"3DHP command line {name}: no checkpoint, epoch line or backward")
                    continue
                run_dir = os.path.join(ckdir, name.replace(" ", "_"))
                os.makedirs(run_dir)
                for fname in [f"inference_data_{m}.mat" for m in MODES] + [log_name]:
                    os.replace(os.path.join(ckdir, fname), os.path.join(run_dir, fname))
                lines = open(os.path.join(run_dir, log_name)).read().splitlines()
                nums = [float(x) for line in lines for x in re.findall(r": (\S+) mm$", line)]
                finite = len(nums) == len(lines) == 2 * K_3DHP and all(map(math.isfinite, nums))
                exports = {m: sio.loadmat(os.path.join(run_dir, f"inference_data_{m}.mat"))
                           for m in MODES}
                shapes = all(exports[m][k].shape == (3, J, frames, K_3DHP)
                             and np.isfinite(exports[m][k]).all()
                             for m in MODES for k in ("TS1", "TS2"))
                ok = finite and shapes and counts == want
                out[name].update(per_micro_batch_s=evaluate_s[-1] / n_batches,
                                 log_mm=nums, lines=lines)
                log(f"[cli-3dhp] {name}: {out[name]['seconds']:.1f} s, evaluate "
                    f"{evaluate_s[-1]:.2f} s = {out[name]['per_micro_batch_s']:.3f} s per "
                    f"micro-batch of {B_3DHP} windows ({n_batches} micro-batches, H={H_3DHP}, "
                    f"K={K_3DHP}, {ROWS_3DHP} hypothesis rows); {len(nums)} log numbers finite "
                    f"{finite}, last step P_Best {nums[-2]:.2f} P_Agg {nums[-1]:.2f} mm; exports "
                    f"(3, {J}, {frames}, {K_3DHP}) per sequence {shapes}; launches {counts} "
                    f"(expected {want}) {'ok' if ok else 'FAIL'}")
                check(ok, f"3DHP command line {name}: log numbers, exports or launch counts")
                out[name]["exports"] = exports
        # level 5 against level 4: the same seed, so the same draws
        e4, e5 = out["eval L4"].pop("exports"), out["eval L5"].pop("exports")
        equal = all(np.array_equal(e4[m][k], e5[m][k]) for m in MODES for k in ("TS1", "TS2"))
        same_log = out["eval L4"]["lines"] == out["eval L5"]["lines"]
        log(f"[cli-3dhp] level 5 exports equal to level 4's bit for bit {equal}, log lines "
            f"equal {same_log} {'ok' if equal and same_log else 'FAIL'}")
        check(equal and same_log, "3DHP evaluation: level 5 differs from level 4")

        annot = os.path.join(ckdir, "3dhp_test")
        write_3dhp_annotations(annot, make_synthetic(seed=seed, frames=frames), frames)
        out["pck_auc"] = {}
        for m in MODES:
            summaries = evaluate_3dhp_mat(
                os.path.join(ckdir, "eval_L4", f"inference_data_{m}.mat"), annot, m,
                os.path.join(ckdir, "pck"), n_seq=2)
            finite = sorted(summaries) == list(range(1, K_3DHP + 1)) and all(
                math.isfinite(v) for sm in summaries.values() for v in sm.values())
            last = summaries[K_3DHP]
            out["pck_auc"][m] = last
            log(f"[cli-3dhp] PCK/AUC of the level-4 {m} export, step {K_3DHP}: MPJPE "
                f"{last['mpjpe']:.2f} mm, PCK {last['pck']:.2f}, AUC {last['auc']:.2f}; "
                f"{len(summaries)} steps finite {finite} {'ok' if finite else 'FAIL'}")
            check(finite, f"PCK/AUC of the {m} export: missing steps or non-finite numbers")
        n_csv = len(os.listdir(os.path.join(ckdir, "pck")))
        check(n_csv == 2 * len(MODES) * K_3DHP, f"PCK/AUC wrote {n_csv} CSV files")
    finally:
        main_3dhp.Evaluator3DHP.evaluate = real_evaluate
        shutil.rmtree(ckdir, ignore_errors=True)
    for name in ("eval L4", "eval L5"):
        out[name].pop("lines", None)
    record["cli_3dhp"] = out


# the in-the-wild track: 1,000 frames of COCO-layout keypoints in a
# 1920x1080 frame, 5 windows of 243 (the last right-aligned), 4 a sampling
# call at -b 1024 (2 calls, the second padded by 3 rows)
WILD_FRAMES, WILD_SIZE = 1000, (1920, 1080)


def wild_track(frames, seed):
    """A seeded (frames, 17, 2) pixel track: one pose about 320 px tall,
    drifting across the frame, each joint jittered."""
    rs = np.random.RandomState(seed)
    pose = rs.randn(17, 2) * np.array([80.0, 160.0])
    drift = np.cumsum(rs.randn(frames, 1, 2) * 2.0, axis=0)
    jitter = rs.randn(frames, 17, 2) * 3.0
    return (np.array([WILD_SIZE[0] / 2, WILD_SIZE[1] / 2]) + pose + drift + jitter
            ).astype(np.float32)


def np_qrot(q, v):
    """Rotate (..., 3) vectors by the quaternion q (4,) in float64 numpy
    (the formula of common/quaternion.py)."""
    q, v = np.asarray(q, np.float64), np.asarray(v, np.float64)
    qvec = np.broadcast_to(q[1:], v.shape)
    uv = np.cross(qvec, v)
    return v + 2 * (q[0] * uv + np.cross(qvec, uv))


def phase_wild(torch, record):
    """The in-the-wild, render and draw entry points at the published width,
    bf16, H=5, K=5, flip-TTA, weights from a seed:
      * `in_the_wild.inference.lift_keypoints` (the pipeline after the
        detector and the frame size) on a 1,000-frame track at fuse levels 4
        and 5 from one checkpoint and seed: predictions (5, 5, 1000, 17, 3)
        finite, level 5 equal to level 4 bit for bit, exact launch counts
        (2 sampling calls), the world frame of H36M_ROT against a float64
        numpy rotation of the same stack at 1e-5 with min z = 0, both .npy
        exports written; seconds per micro-batch from the sampler's wall
        time;
      * the H36M command line's `--render --viz-export` (and `--viz-output`
        as a gif where matplotlib is installed) on the synthetic data: the
        export (Ftot, 17, 3) finite and equal to stitch_windows of the
        evaluator's prediction return, exact launch counts;
      * main_draw on the synthetic data (with its plots where matplotlib is
        installed): (5, 5, Ftot, 17, 3) hypotheses and finite reprojections;
      * the in-the-wild `main` (what `inference_video` runs) on an npz
        track beside a 1920x1080 mp4 where cv2 is installed, its plots
        where matplotlib is: equal to the level-4 run.
    A step whose library is not installed is left out with a line saying so.
    Outputs go to a directory under log/ (git-ignored) that is removed
    afterwards; the entry points' own output to
    chiprun_out/chip_smoke_wild.log."""
    import importlib.util

    from d3dp_tpu_torch.cli import main_draw, main_h36m
    from d3dp_tpu_torch.cli.arguments import parse_args
    from d3dp_tpu_torch.data.windowing import stitch_windows
    from d3dp_tpu_torch.eval import Evaluator
    from d3dp_tpu_torch.in_the_wild import inference
    from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig
    from d3dp_tpu_torch.train.checkpoint_io import save_checkpoint

    have = {m: importlib.util.find_spec(m) is not None for m in ("matplotlib", "cv2")}
    log("[wild] in this Python environment: " + ", ".join(
        f"{m} {'installed' if v else 'not installed'}" for m, v in have.items()))
    seed = 1
    home = os.getcwd()
    workdir = os.path.join(home, "log", "chip_smoke_wild")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    bs = 1024 // F
    n_batches = math.ceil(math.ceil(WILD_FRAMES / F) / bs)
    wild_argv = ["-f", str(F), "-cs", str(C), "-dep", str(DEPTH), "--dtype", "bfloat16",
                 "-num_proposals", str(H), "-sampling_timesteps", str(K), "-b", "1024",
                 "--seed", str(seed)]
    out = dict(have)
    sample_s, returned = [], []
    real_sample, real_evaluate = inference.sample_video_keypoints, Evaluator.evaluate

    def timed_sample(*a, **k):
        t0 = time.perf_counter()
        try:
            return real_sample(*a, **k)  # ends in the stack's copy to the host
        finally:
            sample_s.append(time.perf_counter() - t0)

    def recorded_evaluate(self, *a, **k):
        res = real_evaluate(self, *a, **k)
        returned.append(res)
        return res

    def run(f, fn, *a):
        reset_counts()
        with contextlib.redirect_stdout(f):
            res = fn(*a)
        torch.cuda.synchronize()
        return res, {n: c for n, c in read_counts().items() if c}

    try:
        os.chdir(workdir)
        inference.sample_video_keypoints = timed_sample
        Evaluator.evaluate = recorded_evaluate
        model = MixSTE2(MixSTEConfig(num_frames=F, embed_dim=C, depth=DEPTH, num_heads=HEADS),
                        "cuda", seed=seed)
        perturb_(torch, model, seed)
        ckpt = os.path.join(workdir, "wild.ckpt")
        save_checkpoint(ckpt, epoch=0, lr=0.0, model=model)
        del model
        kps = wild_track(WILD_FRAMES, seed)
        shape = (K, H, WILD_FRAMES, J, 3)
        lifted = {}
        with open(os.path.join(home, "chiprun_out", "chip_smoke_wild.log"), "w") as f:
            for level in (4, 5):
                args = parse_args(wild_argv + ["--fuse-level", str(level)], in_the_wild=True)
                args.video_name, args.evaluate = f"wild_L{level}", ckpt
                (pred, world), counts = run(f, inference.lift_keypoints, args, kps, *WILD_SIZE)
                want = {n: n_batches * per_forward(level) * K for n in LEVEL_KERNELS[level]}
                saved = [np.load(os.path.join("outputs", args.video_name, name)) for name in
                         (f"test_3d_{args.video_name}_output.npy",
                          f"test_3d_output_{args.video_name}_postprocess.npy")]
                ok = (pred.shape == world.shape == shape and np.isfinite(pred).all()
                      and np.isfinite(world).all() and counts == want
                      and np.array_equal(saved[0], pred) and np.array_equal(saved[1], world))
                out[f"L{level}"] = dict(sample_s=sample_s[-1], launches=counts,
                                        per_micro_batch_s=sample_s[-1] / n_batches)
                log(f"[wild] level {level}: {WILD_FRAMES} frames, {n_batches} micro-batches of "
                    f"{bs} windows (H={H}, K={K}, {ROWS} hypothesis rows): sampling "
                    f"{sample_s[-1]:.3f} s = {sample_s[-1] / n_batches:.3f} s per micro-batch "
                    f"({record['card']}); prediction {pred.shape} finite "
                    f"{bool(np.isfinite(pred).all())}, both exports written; launches {counts} "
                    f"(expected {want}) {'ok' if ok else 'FAIL'}")
                check(ok, f"in-the-wild level {level}: shapes, exports or launch counts")
                lifted[level] = (pred, world)
            equal = np.array_equal(lifted[4][0], lifted[5][0]) and \
                np.array_equal(lifted[4][1], lifted[5][1])
            ref = np_qrot(inference.H36M_ROT, lifted[4][0])
            ref[..., 2] -= ref[..., 2].min()
            err = float(np.abs(lifted[4][1] - ref).max())
            zmin = float(lifted[4][1][..., 2].min())
            ok = equal and err <= 1e-5 and zmin == 0.0
            out.update(level5_equal=equal, world_max_abs_err=err)
            log(f"[wild] level 5 equal to level 4 bit for bit {equal}; world frame against "
                f"numpy qrot max |err| {err:.2e} (<= 1e-5), min z {zmin} "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, "in-the-wild: level 5 differs from level 4, or the world frame is off")

            # --render on the synthetic data (S9 "Act0 1": a third of 1,200
            # frames, 2 windows, one micro-batch of -b 4 windows)
            frames = 1200 // 3
            syn = ["-d", "synthetic", "--synthetic-frames", "1200", "--nolog", "-cs", str(C),
                   "-dep", str(DEPTH), "-f", str(F), "--dp", "1"]  # one process, as phase cli
            render_argv = syn + ["--dtype", "bfloat16", "-num_proposals", str(H),
                                 "-sampling_timesteps", str(K), "-b", str(B), "--seed",
                                 str(seed), "-c", os.path.join(workdir, "ck"), "--render",
                                 "--viz-subject", "S9", "--viz-action", "Act0 1",
                                 "--viz-export", "render.npy"]
            if have["matplotlib"]:
                render_argv += ["--viz-output", "render.gif", "--viz-limit", "5"]
            else:
                log("[wild] --viz-output left out: matplotlib is not installed here "
                    "(the gif is held on the CPU by tests/test_torch_draw_render.py)")
            _, counts = run(f, main_h36m.main, render_argv)
            export = np.load("render.npy")
            stitched = stitch_windows(returned[-1][:, -1, 0], frames)
            want = {n: per_forward(4) * K for n in LEVEL_KERNELS[4]}
            gif = have["matplotlib"] and os.path.getsize("render.gif") > 1000
            ok = export.shape == (frames, J, 3) and np.isfinite(export).all() and \
                np.array_equal(export, stitched) and counts == want and \
                (gif or not have["matplotlib"])
            out["render"] = dict(launches=counts, gif=gif)
            log(f"[wild] --render --viz-export: {export.shape} finite "
                f"{bool(np.isfinite(export).all())}, equal to stitch_windows of the prediction "
                f"return {np.array_equal(export, stitched)}; gif written {gif}; launches "
                f"{counts} (expected {want}) {'ok' if ok else 'FAIL'}")
            check(ok, "--render: export, animation or launch counts")

            draw_argv = syn + ["--dtype", "bfloat16", "-num_proposals", str(H),
                               "-sampling_timesteps", str(K), "--seed", str(seed),
                               "--viz-limit", "3"]
            if have["matplotlib"]:
                h, counts = run(f, main_draw.main, draw_argv)
                plots = sorted(os.listdir(os.path.join("plot", "synthetic", "S9_Act0_1_0")))
            else:
                log("[wild] main_draw's plots left out: matplotlib is not installed here "
                    "(held on the CPU by tests/test_torch_draw_render.py); its hypotheses "
                    "run here")
                h, counts = run(f, main_draw.hypotheses, parse_args(draw_argv))
                plots = []
            ok = h["preds"].shape == (K, H, frames, J, 3) and np.isfinite(h["preds"]).all() \
                and np.isfinite(h["pred_2d"]).all() and counts == want and \
                len(plots) == (3 if have["matplotlib"] else 0)
            out["draw"] = dict(launches=counts, plots=len(plots))
            log(f"[wild] main_draw: hypotheses {h['preds'].shape} and reprojections finite, "
                f"{len(plots)} plots; launches {counts} (expected {want}) "
                f"{'ok' if ok else 'FAIL'}")
            check(ok, "main_draw: hypotheses, plots or launch counts")

            if have["cv2"]:
                import cv2

                vw = cv2.VideoWriter("wild.mp4", cv2.VideoWriter_fourcc(*"mp4v"), 25, WILD_SIZE)
                for _ in range(10):
                    vw.write(np.full((WILD_SIZE[1], WILD_SIZE[0], 3), 128, np.uint8))
                vw.release()
                np.savez("wild.npz", kpts=kps)
                # inference_video's namespace, plots only where matplotlib is
                args = parse_args(wild_argv + ["--viz-limit", "2"], in_the_wild=True)
                args.detector_2d, args.video_name, args.viz_video = "npz", "wild", "wild.mp4"
                args.evaluate, args.render_frames = ckpt, have["matplotlib"]
                if not have["matplotlib"]:
                    log("[wild] in-the-wild main's plots left out: matplotlib is not installed "
                        "here (held on the CPU by tests/test_torch_wild.py)")
                world, counts = run(f, inference.main, args)
                plot_dir = os.path.join("outputs", "wild", "wild_wild_0")
                plots = os.listdir(plot_dir) if os.path.isdir(plot_dir) else []
                want = {n: n_batches * per_forward(4) * K for n in LEVEL_KERNELS[4]}
                ok = np.array_equal(world, lifted[4][1]) and counts == want and \
                    len(plots) == (2 if have["matplotlib"] else 0)
                out["inference_main"] = dict(launches=counts, plots=len(plots))
                log(f"[wild] in-the-wild main on an npz track beside a {WILD_SIZE[0]}x"
                    f"{WILD_SIZE[1]} mp4 (frame size from cv2): equal to the level-4 run "
                    f"{np.array_equal(world, lifted[4][1])}, {len(plots)} plots; launches "
                    f"{counts} (expected {want}) {'ok' if ok else 'FAIL'}")
                check(ok, "in-the-wild main: prediction, plots or launch counts")
            else:
                log("[wild] in-the-wild main left out: cv2 (the frame size) is not installed "
                    "here (held on the CPU by tests/test_torch_wild.py); its pipeline "
                    "after the detector and the frame size ran above")
    finally:
        os.chdir(home)
        inference.sample_video_keypoints = real_sample
        Evaluator.evaluate = real_evaluate
        shutil.rmtree(workdir, ignore_errors=True)
    record["wild"] = out


def phase_train_model(torch, record):
    """MixSTE2 fp32, full width, depth 2, DropPath 0.1: one train_forward
    loss and every gradient on the kernel path (K3 forward, K4 backward)
    against the plain path, with the same t, noise and DropPath masks.
    Tolerance: loss 1e-5 relative; each parameter's gradient 1e-3 relative
    in norm (fp32 summation order only, through two depths of backward)."""
    from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
    from d3dp_tpu_torch.models import MixSTEConfig
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.train.state import weighted_mpjpe

    d3dp = D3DP(D3DPConfig(model=MixSTEConfig(num_frames=F, embed_dim=C, depth=2,
                                              drop_path_rate=0.1)), seed=5)
    perturb_(torch, d3dp.model, 6)
    g = torch.Generator(device="cuda").manual_seed(8)
    x2d = torch.randn(2, F, J, 2, generator=g, device="cuda") * 0.3
    x3d = torch.randn(2, F, J, 3, generator=g, device="cuda") * 0.3
    x3d[:, :, 0] = 0.0
    noise = torch.randn(2, F, J, 3, generator=g, device="cuda")
    t = torch.tensor([999, 17], device="cuda")
    w = torch.ones(2, device="cuda")

    def run():
        d3dp.model.zero_grad(set_to_none=True)
        masks = torch.Generator(device="cuda").manual_seed(9)  # same masks on both paths
        pred = d3dp.train_forward(x2d, x3d, generator=masks, t_noise_override=(t, noise))
        loss = weighted_mpjpe(pred, x3d, w)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in d3dp.model.named_parameters()}

    n0 = (A.fused_attention_qkv.launches, A.fused_attention_qkv_bwd.launches)
    loss_k, grads_k = run()
    launched = (A.fused_attention_qkv.launches - n0[0], A.fused_attention_qkv_bwd.launches - n0[1])
    with plain_ops():
        loss_p, grads_p = run()
    torch.cuda.synchronize()
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    rel = {n: ((grads_k[n] - grads_p[n]).norm() / grads_p[n].norm()).item() for n in grads_p}
    worst = max(rel, key=rel.get)
    ok = (math.isfinite(loss_k) and loss_rel <= 1e-5 and rel[worst] <= 1e-3
          and launched == (4, 4))
    log(f"[train-model] MixSTE2 fp32 C={C} depth 2 B=2 DropPath 0.1: loss kernel {loss_k:.6f} "
        f"plain {loss_p:.6f} (rel {loss_rel:.2e}, tol 1e-5); worst gradient {worst} rel "
        f"{rel[worst]:.2e} (tol 1e-3, {len(rel)} parameters); launches K3 {launched[0]} "
        f"K4 {launched[1]} (expected 4, 4) {'ok' if ok else 'FAIL'}")
    check(ok, "train_forward: kernel path disagrees with the plain path")
    record["train_model_fp32"] = dict(loss_rel=loss_rel, worst_grad=worst,
                                      worst_grad_rel=rel[worst])


def main_config(torch):
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT
    from d3dp_tpu_torch.diffusion import D3DPConfig
    from d3dp_tpu_torch.models import MixSTEConfig

    return D3DPConfig(
        model=MixSTEConfig(num_frames=F, embed_dim=C, depth=DEPTH, num_heads=HEADS,
                           dtype=torch.bfloat16),
        num_proposals=H, sampling_timesteps=K,
        joints_left=tuple(JOINTS_LEFT), joints_right=tuple(JOINTS_RIGHT))


def phase_main(torch, record):
    """The main path: one D3DP.sample call on B windows, then the whole
    Evaluator over the synthetic eval set, P2 on the host."""
    from d3dp_tpu_torch.data.generators import UnchunkedGenerator
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT, make_dataset
    from d3dp_tpu_torch.diffusion import D3DP
    from d3dp_tpu_torch.eval import MODES, Evaluator
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M

    d3dp = D3DP(main_config(torch), seed=0)
    perturb_(torch, d3dp.model, 1)
    g = torch.Generator(device="cuda").manual_seed(2)
    x2d = torch.randn(B, F, J, 2, generator=g, device="cuda") * 0.3
    x2d_f = torch.randn(B, F, J, 2, generator=g, device="cuda") * 0.3
    per_batch = 2 * DEPTH * K

    reset_counts()
    preds = d3dp.sample(x2d, x2d_f, generator=g)
    torch.cuda.synchronize()
    counts = (A.attention_stage.launches, M.mlp_block_t.launches)
    ok = (tuple(preds.shape) == (B, K, H, F, J, 3) and bool(torch.isfinite(preds).all())
          and counts == (per_batch, per_batch))
    log(f"[main] D3DP.sample B={B} H={H} K={K} F={F} bf16 flip-TTA: shape "
        f"{tuple(preds.shape)}, finite {bool(torch.isfinite(preds).all())}, launches "
        f"attention_stage {counts[0]} mlp_block_t {counts[1]} (expected 2*depth*K = "
        f"{per_batch}) {'ok' if ok else 'FAIL'}")
    check(ok, "D3DP.sample: wrong shape, non-finite output or launch counts")

    lengths = (300, 250, 400, 486, 729)
    cams, p3, p2 = make_dataset(seed=3, lengths=lengths)
    gen = UnchunkedGenerator(cams, p3, p2)
    ev = Evaluator(d3dp, receptive_field=F, batch_size=B, p2=True,
                   kps_left=list(JOINTS_LEFT), kps_right=list(JOINTS_RIGHT))
    n_batches = sum(math.ceil(math.ceil(n / F) / B) for n in lengths)
    t0 = time.perf_counter()
    res = ev.evaluate(gen, g)
    p1, p2m = res.averages_mm(), res.averages_p2_mm()
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    counts = (A.attention_stage.launches, M.mlp_block_t.launches)
    expected = per_batch * (1 + n_batches)
    finite = all(np.isfinite(v).all() for v in list(p1.values()) + list(p2m.values()))
    jbest = bool((p1["J_Best"] <= p1["P_Best"] + 1e-9).all())
    ok = finite and jbest and counts == (expected, expected) and set(p1) == set(MODES)
    log(f"[main] Evaluator {len(lengths)} seqs / {sum(lengths)} frames / {n_batches} "
        f"micro-batches of {B}, P2 on host: {eval_s:.2f} s")
    for m in MODES:
        log(f"[main]   {m}: P1 {np.array2string(p1[m], precision=2)} mm, "
            f"P2 {np.array2string(p2m[m], precision=2)} mm")
    log(f"[main] finite {finite}, J_Best <= P_Best {jbest}, launches attention_stage "
        f"{counts[0]} mlp_block_t {counts[1]} (expected {expected} = 2*depth*K x "
        f"{1 + n_batches} sampled micro-batches) {'ok' if ok else 'FAIL'}")
    check(ok, "Evaluator: non-finite metrics, J_Best > P_Best or launch counts")
    record.update(launches={"attention_stage": counts[0], "mlp_block_t": counts[1]},
                  eval_seconds=eval_s, eval_micro_batches=n_batches,
                  metrics_p1_mm={m: p1[m].tolist() for m in MODES},
                  metrics_p2_mm={m: p2m[m].tolist() for m in MODES})
    return d3dp, x2d, x2d_f, counts


def phase_p2_device(torch, record, d3dp):
    """Protocol-2 on the device against Protocol-2 on the host, on the main
    path's model (H=5, K=5, bf16, level 4) and evaluation set, one injected
    noise stream for every run: `Evaluator(p2_device=True)`'s P1 equal to
    `Evaluator(p2=True)`'s bit for bit, its P2 within tests/test_eval.py's
    bound (rtol 2e-3, atol 5e-3 mm). Wall times of host P2, device P2 and
    P1 alone, in the order host, device, P1 alone, device, host. First,
    what the alignment costs on one micro-batch's 24,300 poses (P-Best's,
    J-Best's and J-Agg's; P-Agg aligns 4,860): its CUDA-event time, the
    SVD's alone, and the host synchronizations a call makes (torch's sync
    debug mode)."""
    import warnings

    from d3dp_tpu_torch.data.generators import UnchunkedGenerator
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT, make_dataset
    from d3dp_tpu_torch.eval import MODES, Evaluator
    from d3dp_tpu_torch.metrics.procrustes import procrustes_align

    out = {}
    g = torch.Generator(device="cuda").manual_seed(51)
    M = B * K * H * F
    pose = torch.randn(M, J, 3, generator=g, device="cuda") * 100
    target = pose + torch.randn(M, J, 3, generator=g, device="cuda") * 10
    cov = torch.randn(M, 3, 3, generator=g, device="cuda")
    out["align_ms"] = time_ms(torch, lambda: procrustes_align(pose, target), reps=5)
    out["svd_ms"] = time_ms(torch, lambda: torch.linalg.svd(cov), reps=5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            procrustes_align(pose, target)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    out["syncs_per_align"] = sum("synchroniz" in str(w.message).lower() for w in caught)
    log(f"[p2] procrustes_align on {M} poses of {J} joints: {out['align_ms']:.4f} ms (CUDA "
        f"events, median of 5), torch.linalg.svd of {M} 3x3 alone {out['svd_ms']:.4f} ms; "
        f"{out['syncs_per_align']} host synchronization(s) per call")
    del pose, target, cov

    lengths = (300, 250, 400, 486, 729)
    data = make_dataset(seed=3, lengths=lengths)
    n_batches = sum(math.ceil(math.ceil(n / F) / B) for n in lengths)

    def provider():
        rs = np.random.RandomState(50)
        return lambda n: (rs.randn(n, H, F, J, 3).astype(np.float32),
                          rs.randn(K, n, H, F, J, 3).astype(np.float32))

    res, walls = {}, {}
    for name, kw in (("host", dict(p2=True)), ("device", dict(p2_device=True)), ("p1", {}),
                     ("device", dict(p2_device=True)), ("host", dict(p2=True))):
        ev = Evaluator(d3dp, receptive_field=F, batch_size=B, kps_left=list(JOINTS_LEFT),
                       kps_right=list(JOINTS_RIGHT), **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ev.evaluate(UnchunkedGenerator(*data), noise_provider=provider())
        got = (r.averages_mm(), r.averages_p2_mm() if kw else None)
        torch.cuda.synchronize()
        walls.setdefault(name, []).append(time.perf_counter() - t0)
        res.setdefault(name, got)
    (h1, h2), (d1, d2), (p1, _) = res["host"], res["device"], res["p1"]
    p1_equal = all(np.array_equal(d1[m], h1[m]) and np.array_equal(p1[m], h1[m]) for m in MODES)
    p2_close = all(np.isfinite(d2[m]).all() and
                   np.allclose(d2[m], h2[m], rtol=2e-3, atol=5e-3) for m in MODES)
    worst = max(float(np.abs(d2[m] - h2[m]).max()) for m in MODES)
    ok = p1_equal and p2_close
    log(f"[p2] Evaluator {len(lengths)} seqs / {n_batches} micro-batches of {B}, H={H} K={K} "
        f"bf16: wall s host P2 {walls['host']}, device P2 {walls['device']}, P1 alone "
        f"{walls['p1']}; P1 equal {p1_equal}; device P2 vs host max|diff| {worst:.3e} mm "
        f"(rtol 2e-3, atol 5e-3) {'ok' if ok else 'FAIL'}")
    for m in MODES:
        log(f"[p2]   {m}: P2 host {np.array2string(h2[m], precision=4)} device "
            f"{np.array2string(d2[m], precision=4)} mm")
    check(ok, "Evaluator(p2_device=True): P1 differs from host P2's run or P2 out of bound")
    out.update(wall_s=walls, micro_batches=n_batches, p2_max_abs_diff_mm=worst,
               p2_host_mm={m: h2[m].tolist() for m in MODES},
               p2_device_mm={m: d2[m].tolist() for m in MODES})
    record["p2_device"] = out


def train_config(torch):
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT
    from d3dp_tpu_torch.diffusion import D3DPConfig
    from d3dp_tpu_torch.models import MixSTEConfig

    # validation samples one hypothesis in one DDIM step (H=1, K=1)
    return D3DPConfig(
        model=MixSTEConfig(num_frames=F, embed_dim=C, depth=DEPTH, num_heads=HEADS,
                           drop_path_rate=0.1, dtype=torch.bfloat16),
        num_proposals=1, sampling_timesteps=1,
        joints_left=tuple(JOINTS_LEFT), joints_right=tuple(JOINTS_RIGHT))


def phase_train(torch, record):
    """The training path: ChunkedGenerator -> Prefetcher -> make_train_step
    for TRAIN_STEPS steps, then steps on one repeated batch, an lr decay,
    and light validation on the trained weights against a fresh model
    loaded from their state_dict."""
    from torch.profiler import ProfilerActivity, profile

    from d3dp_tpu_torch.data.generators import ChunkedGenerator, UnchunkedGenerator
    from d3dp_tpu_torch.data.prefetch import Prefetcher
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT, make_dataset
    from d3dp_tpu_torch.diffusion import D3DP
    from d3dp_tpu_torch.eval import Evaluator
    from d3dp_tpu_torch.models import MixSTE2
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.train.state import get_lr, make_optimizer, make_train_step, set_lr

    cfg = train_config(torch)
    d3dp = D3DP(cfg, seed=0)
    opt = make_optimizer(d3dp.model.parameters(), 6e-5)
    step = make_train_step(d3dp, opt)
    lr_kw = dict(kps_left=list(JOINTS_LEFT), kps_right=list(JOINTS_RIGHT))
    # 19 windows of 243 frames, twice with flip augmentation: 10 batches of
    # 4 per epoch, the last padded (2 real rows)
    lengths = (1200, 900, 1500, 700)
    gen = ChunkedGenerator(BT, *make_dataset(seed=5, lengths=lengths), F, shuffle=True,
                           random_seed=1234, augment=True, endless=True, pad_last=True,
                           joints_left=list(JOINTS_LEFT), joints_right=list(JOINTS_RIGHT),
                           **lr_kw)
    val_data = make_dataset(seed=6, lengths=(500, 400))

    def validate(d):
        ev = Evaluator(d, receptive_field=F, batch_size=4, light=True, **lr_kw)
        res = ev.evaluate(UnchunkedGenerator(*val_data),
                          torch.Generator(device="cuda").manual_seed(21))
        return res.averages_mm()["P_Best"]

    before = validate(d3dp)  # builds the eval path's weight cache
    g = torch.Generator(device="cuda").manual_seed(11)
    batches = iter(Prefetcher(gen.next_epoch(), depth=2))
    warm = 3
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    for i in range(TRAIN_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        _, b3d, b2d, w = next(batches)
        losses.append(step(b2d, b3d, w, generator=g))
        if i == 0:
            first = (b2d, b3d, w)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - warm)
    counts = (A.fused_attention_qkv.launches, A.fused_attention_qkv_bwd.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batches.close()
    losses = [v.item() for v in losses]
    per_step = 2 * DEPTH  # one spatial and one temporal attention core per depth
    ok = all(math.isfinite(v) for v in losses) and counts == (per_step * TRAIN_STEPS,) * 2
    log(f"[train] {TRAIN_STEPS} steps, batch {BT}x{F} frames, bf16, DropPath 0.1, AdamW 6e-5: "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, finite {ok}; launches K3 {counts[0]} "
        f"K4 {counts[1]} (expected {per_step}/step x {TRAIN_STEPS} = {per_step * TRAIN_STEPS}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "train steps: non-finite loss or launch counts")
    fps = BT * F / step_s
    log(f"[train] {step_s:.4f} s/step (mean of steps {warm + 1}-{TRAIN_STEPS}, host loop with "
        f"prefetch), {fps:.1f} train frames/s, peak memory {peak_gb:.2f} GB")

    # the loss falls on a repeated batch: same rows, t, noise and DropPath
    # masks (a generator reseeded alike for every step draws only the masks)
    r = torch.Generator(device="cuda").manual_seed(12)
    t_fix = torch.randint(0, 1000, (BT,), generator=r, device="cuda")
    noise_fix = torch.randn(BT, F, J, 3, generator=r, device="cuda")
    rep = [step(*first, generator=torch.Generator(device="cuda").manual_seed(13),
                t_noise_override=(t_fix, noise_fix)).item() for _ in range(10)]
    falls = rep[-1] < rep[0] and sum(rep[-3:]) < sum(rep[:3])
    log(f"[train] repeated batch, 10 steps: loss {' '.join(f'{v:.4f}' for v in rep)} "
        f"{'falls ok' if falls else 'FAIL'}")
    check(falls, "train steps: the loss does not fall on a repeated batch")

    lr0 = get_lr(opt)
    set_lr(opt, lr0 * 0.993)
    check(abs(get_lr(opt) - lr0 * 0.993) < 1e-12, "set_lr did not take")

    # light validation on the trained weights == a fresh model loaded from
    # their state_dict (the eval cache follows the optimizer's updates)
    after = validate(d3dp)
    fresh = MixSTE2(cfg.model, seed=99)
    fresh.load_state_dict(d3dp.model.state_dict())
    again = validate(D3DP(cfg, model=fresh))
    ok = bool(np.array_equal(after, again)) and not np.array_equal(after, before) and \
        bool(np.isfinite(after).all())
    log(f"[train] light validation (H=1, K=1) P-Best: before training {before[-1]:.3f} mm, "
        f"after {after[-1]:.3f} mm, fresh model from the trained state_dict {again[-1]:.3f} mm, "
        f"equal {bool(np.array_equal(after, again))} {'ok' if ok else 'FAIL'}")
    check(ok, "validation after training differs from a reloaded model, or did not move")

    # where one step's device time goes
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(*first, generator=g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    prof_rec = summarize_profile(torch, prof, wall_ms, "one train step", "train-profile")
    if prof_rec["device_busy_ms"] is not None:
        log(f"[train-profile] the profiler slows the host: against the unprofiled "
            f"{step_s * 1e3:.1f} ms/step the card is busy "
            f"{100 * prof_rec['device_busy_ms'] / (step_s * 1e3):.1f}% of a step")
    record.update(train=dict(step_s=step_s, frames_per_s=fps, peak_gb=peak_gb, losses=losses,
                             repeated_batch_losses=rep, val_before_mm=before.tolist(),
                             val_after_mm=after.tolist(), profile=prof_rec))
    record["launches"].update(fused_attention_qkv=counts[0], fused_attention_qkv_bwd=counts[1])
    del d3dp, opt, step
    train_fp32(torch, record)


FP32_TRAIN_STEPS = 8


def train_fp32(torch, record):
    """fp32, the default --dtype of every entry point: FP32_TRAIN_STEPS
    Train-config steps from ChunkedGenerator + Prefetcher, K3 and K4
    launched exactly 2 x depth times a step each, finite losses, s/step, and
    one profiled step's device time with K4's share."""
    from torch.profiler import ProfilerActivity, profile

    from d3dp_tpu_torch.data.generators import ChunkedGenerator
    from d3dp_tpu_torch.data.prefetch import Prefetcher
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT, make_dataset
    from d3dp_tpu_torch.diffusion import D3DP
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import linear as L
    from d3dp_tpu_torch.train.state import make_optimizer, make_train_step
    from d3dp_tpu_torch.utils import profiling

    cfg = train_config(torch)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=torch.float32))
    d3dp = D3DP(cfg, seed=0)
    step = make_train_step(d3dp, make_optimizer(d3dp.model.parameters(), 6e-5))
    gen = ChunkedGenerator(BT, *make_dataset(seed=5, lengths=(1200, 900, 1500, 700)), F,
                           shuffle=True, random_seed=1234, augment=True, endless=True,
                           pad_last=True, joints_left=list(JOINTS_LEFT),
                           joints_right=list(JOINTS_RIGHT), kps_left=list(JOINTS_LEFT),
                           kps_right=list(JOINTS_RIGHT))
    batches = iter(Prefetcher(gen.next_epoch(), depth=2))
    g = torch.Generator(device="cuda").manual_seed(11)
    warm, losses = 2, []
    torch.cuda.synchronize()
    reset_counts()
    gemms0 = L.gemm.launches
    for i in range(FP32_TRAIN_STEPS):
        if i == warm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        _, b3d, b2d, w = next(batches)
        losses.append(step(b2d, b3d, w, generator=g))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / (FP32_TRAIN_STEPS - warm)
    counts = (A.fused_attention_qkv.launches, A.fused_attention_qkv_bwd.launches)
    gemms = L.gemm.launches - gemms0
    losses = [v.item() for v in losses]
    per_step = 2 * DEPTH
    # the block linears on the tf32x3 GEMM: 4 a block, forward and input gradient
    gemm_step = 2 * 4 * per_step
    finite = all(math.isfinite(v) for v in losses)
    ok = finite and counts == (per_step * FP32_TRAIN_STEPS,) * 2 and \
        gemms == gemm_step * FP32_TRAIN_STEPS
    log(f"[train-fp32] {FP32_TRAIN_STEPS} steps, batch {BT}x{F} frames, fp32, DropPath 0.1, "
        f"AdamW 6e-5: loss {' '.join(f'{v:.4f}' for v in losses)}, finite {finite}")
    log(f"[train-fp32] launches K3 {counts[0]} K4 {counts[1]} (expected {per_step}/step x "
        f"{FP32_TRAIN_STEPS} = {per_step * FP32_TRAIN_STEPS} each), tf32x3 linears {gemms} "
        f"(expected {gemm_step}/step x {FP32_TRAIN_STEPS} = {gemm_step * FP32_TRAIN_STEPS}) "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "fp32 train steps: non-finite loss or launch counts")
    log(f"[train-fp32] {step_s:.4f} s/step (mean of steps {warm + 1}-{FP32_TRAIN_STEPS}, host "
        f"loop with prefetch), {BT * F / step_s:.1f} train frames/s")
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(b2d, b3d, w, generator=g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    batches.close()
    counted = profiling.counters().get("linear_tf32x3", 0)
    log(f"[train-fp32] the recorder's linear_tf32x3 counter over one profiled step: {counted} "
        f"(expected {gemm_step}) {'ok' if counted == gemm_step else 'FAIL'}")
    check(counted == gemm_step, "fp32 train step: the linear_tf32x3 counter")
    prof_rec = summarize_profile(torch, prof, wall_ms, "one fp32 train step", "train-fp32-profile")
    k4_ms = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA and "attn_bwd" in e.key) / 1e3
    busy = prof_rec["device_busy_ms"]
    log(f"[train-fp32] K4 device time {k4_ms:.3f} ms a step"
        + (f", {100 * k4_ms / busy:.1f}% of the busy {busy:.1f} ms" if busy else
           " (device busy time not measured)"))
    lin_ms = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and ("linear_tf32x3" in e.key or "tf32_planes" in e.key)) / 1e3
    log(f"[train-fp32] tf32x3 linears and their splits: {lin_ms:.3f} ms a step")
    record["train_fp32"] = dict(step_s=step_s, losses=losses, launches=list(counts),
                                linear_tf32x3=gemms, k4_device_ms=k4_ms, linear_device_ms=lin_ms,
                                profile=prof_rec)


def train_fused_counts(level, depth):
    """Launches of one D3DP_TRAIN_FUSED=1 train step with DropPath active on
    every block but block 0 of each kind: those 2 blocks take the level's
    fused ops, the others the composed block (levels 1-3) or the DropPath
    forms (level 4); every attention core runs K3 once (forward or the
    backward's recompute) and K4 once."""
    n, k = 2 * depth, 2
    core = {"fused_attention_qkv": n, "fused_attention_qkv_bwd": n}
    return {1: {"mlp_block": k}, 2: {"attention_block": k, "mlp_block": k},
            3: {"attention_block": k, "mlp_block_t": k},
            4: {"attention_stage": k, "attention_stage_dp": n - k, "mlp_block_t": k,
                "mlp_block_t_dp": n - k}}[level] | core


def phase_train_fused(torch, record):
    """The D3DP_TRAIN_FUSED=1 training path. Correctness: MixSTE2 fp32,
    full width, depth 2, DropPath 0.1, at fuse levels 1-4: loss and every
    gradient against the composed path under the same t, noise and masks
    (loss 1e-5 relative, gradients 1e-3 relative in norm), with the
    launches of each level's route. Timing: TRAIN_STEPS full-width bf16
    steps at the train config (level 4) fed as phase train feeds them,
    then as many on the composed path in the same run; launch counts per
    step; one profiled fused step."""
    from torch.profiler import ProfilerActivity, profile

    from d3dp_tpu_torch.data.generators import ChunkedGenerator
    from d3dp_tpu_torch.data.prefetch import Prefetcher
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT, make_dataset
    from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
    from d3dp_tpu_torch.models import MixSTEConfig
    from d3dp_tpu_torch.train.state import make_optimizer, make_train_step, weighted_mpjpe

    out = {}
    d3dp = D3DP(D3DPConfig(model=MixSTEConfig(num_frames=F, embed_dim=C, depth=2,
                                              drop_path_rate=0.1)), seed=5)
    perturb_(torch, d3dp.model, 6)
    g = torch.Generator(device="cuda").manual_seed(8)
    x2d = torch.randn(2, F, J, 2, generator=g, device="cuda") * 0.3
    x3d = torch.randn(2, F, J, 3, generator=g, device="cuda") * 0.3
    x3d[:, :, 0] = 0.0
    noise = torch.randn(2, F, J, 3, generator=g, device="cuda")
    t = torch.tensor([999, 17], device="cuda")
    w = torch.ones(2, device="cuda")

    def run(fused):
        with env_var("D3DP_TRAIN_FUSED", "1" if fused else None):
            d3dp.model.zero_grad(set_to_none=True)
            masks = torch.Generator(device="cuda").manual_seed(9)  # same masks on both paths
            reset_counts()
            pred = d3dp.train_forward(x2d, x3d, generator=masks, t_noise_override=(t, noise))
            loss = weighted_mpjpe(pred, x3d, w)
            loss.backward()
            torch.cuda.synchronize()
            return (loss.item(), {n: p.grad.clone() for n, p in d3dp.model.named_parameters()},
                    {n: c for n, c in read_counts().items() if c})

    loss_c, grads_c, _ = run(False)
    for level in (1, 2, 3, 4):
        set_level(d3dp.model, level)
        loss_f, grads_f, counts = run(True)
        loss_rel = abs(loss_f - loss_c) / abs(loss_c)
        rel = {n: ((grads_f[n] - grads_c[n]).norm() / grads_c[n].norm()).item() for n in grads_c}
        worst = max(rel, key=rel.get)
        want = train_fused_counts(level, 2)
        ok = (math.isfinite(loss_f) and loss_rel <= 1e-5 and rel[worst] <= 1e-3
              and counts == want)
        log(f"[train-fused] MixSTE2 fp32 C={C} depth 2 B=2 DropPath 0.1 level {level}: loss "
            f"fused {loss_f:.6f} composed {loss_c:.6f} (rel {loss_rel:.2e}, tol 1e-5); worst "
            f"gradient {worst} rel {rel[worst]:.2e} (tol 1e-3); launches {counts} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"train-fused level {level}: disagrees with the composed path, or launches")
        out[f"level{level}"] = dict(loss_rel=loss_rel, worst_grad=worst,
                                    worst_grad_rel=rel[worst])
    del d3dp, grads_c, grads_f

    cfg = train_config(torch)
    d3dp = D3DP(cfg, seed=0)
    step = make_train_step(d3dp, make_optimizer(d3dp.model.parameters(), 6e-5))
    lr_kw = dict(kps_left=list(JOINTS_LEFT), kps_right=list(JOINTS_RIGHT))
    gen = ChunkedGenerator(BT, *make_dataset(seed=5, lengths=(1200, 900, 1500, 700)), F,
                           shuffle=True, random_seed=1234, augment=True, endless=True,
                           pad_last=True, joints_left=list(JOINTS_LEFT),
                           joints_right=list(JOINTS_RIGHT), **lr_kw)
    batches = iter(Prefetcher(gen.next_epoch(), depth=2))
    g = torch.Generator(device="cuda").manual_seed(11)
    warm = 3

    def timed(fused):
        with env_var("D3DP_TRAIN_FUSED", "1" if fused else None):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            losses = []
            for i in range(TRAIN_STEPS):
                if i == warm:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                _, b3d, b2d, bw = next(batches)
                losses.append(step(b2d, b3d, bw, generator=g))
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - warm)
            return dict(step_s=step_s, frames_per_s=BT * F / step_s,
                        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                        losses=[v.item() for v in losses],
                        launches={n: c for n, c in read_counts().items() if c}), b2d, b3d, bw

    fused, *last = timed(True)
    composed, *_ = timed(False)
    want = {n: c * TRAIN_STEPS for n, c in train_fused_counts(4, DEPTH).items()}
    want_c = {n: 2 * DEPTH * TRAIN_STEPS for n in ("fused_attention_qkv",
                                                    "fused_attention_qkv_bwd")}
    ok = (all(math.isfinite(v) for v in fused["losses"] + composed["losses"])
          and fused["launches"] == want and composed["launches"] == want_c)
    log(f"[train-fused] {TRAIN_STEPS} steps, batch {BT}x{F} frames, bf16, DropPath 0.1, level 4, "
        f"D3DP_TRAIN_FUSED=1: loss {fused['losses'][0]:.4f} -> {fused['losses'][-1]:.4f}; "
        f"launches {fused['launches']} (expected {want}) {'ok' if ok else 'FAIL'}")
    check(ok, "train-fused steps: non-finite loss or launch counts")
    for name, r in (("fused", fused), ("composed", composed)):
        log(f"[train-fused] {name}: {r['step_s']:.4f} s/step (mean of steps {warm + 1}-"
            f"{TRAIN_STEPS}, host loop with prefetch), {r['frames_per_s']:.1f} train frames/s, "
            f"peak memory {r['peak_gb']:.2f} GB")
    log(f"[train-fused] fused / composed s/step: {fused['step_s'] / composed['step_s']:.3f}")

    with env_var("D3DP_TRAIN_FUSED", "1"):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            step(*last, generator=g)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
    prof_rec = summarize_profile(torch, prof, wall_ms, "one train-fused step",
                                 "train-fused-profile")
    if prof_rec["device_busy_ms"] is not None:
        log(f"[train-fused-profile] against the unprofiled {fused['step_s'] * 1e3:.1f} ms/step "
            f"the card is busy {100 * prof_rec['device_busy_ms'] / (fused['step_s'] * 1e3):.1f}% "
            f"of a step")
    batches.close()
    out.update(fused=fused, composed=composed, profile=prof_rec)
    record["train_fused"] = out
    record["launches"].update(attention_stage_dp=fused["launches"].get("attention_stage_dp", 0),
                              mlp_block_t_dp=fused["launches"].get("mlp_block_t_dp", 0))


def phase_hmqkv(torch, record, d3dp, x2d, x2d_f):
    """Evaluation with the head-major stage: one D3DP.sample at the eval
    config at level 4 with D3DP_ATTN_VARIANT=hmqkv (K8 on both stages, 80
    launches, no K1), held against the same call without the variant (K8
    equals K1 bit for bit, so the samples are equal), and timed."""
    set_level(d3dp.model, 4)
    ref = d3dp.sample(x2d, x2d_f, generator=torch.Generator(device="cuda").manual_seed(50))
    with env_var("D3DP_ATTN_VARIANT", "hmqkv"):
        reset_counts()
        out = d3dp.sample(x2d, x2d_f, generator=torch.Generator(device="cuda").manual_seed(50))
        torch.cuda.synchronize()
        counts = {n: c for n, c in read_counts().items() if c}
        g = torch.Generator(device="cuda").manual_seed(51)
        sample_ms = time_ms(torch, lambda: d3dp.sample(x2d, x2d_f, generator=g), reps=3)
    diff = (out - ref).abs().max().item()
    equal = torch.equal(out, ref)
    want = {"attention_stage_hm": 2 * DEPTH * K, "mlp_block_t": 2 * DEPTH * K}
    ok = counts == want and bool(torch.isfinite(out).all()) and equal
    log(f"[hmqkv] D3DP.sample B={B} H={H} K={K} F={F} bf16 flip-TTA at level 4, "
        f"D3DP_ATTN_VARIANT=hmqkv: {sample_ms / 1e3:.4f} s/call (median of 3), "
        f"{B * H * F * K * 1e3 / sample_ms:.1f} hyp*frames/s; launches {counts} (expected "
        f"{want}); vs level 4 without the variant max|diff| {diff:.3e}, equal {equal} "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, "D3DP.sample with hmqkv: launch counts, non-finite output, or differs from K1")
    record["hmqkv"] = dict(sample_s=sample_ms / 1e3, launches=counts, max_abs_diff=diff)
    record["launches"]["attention_stage_hm"] = counts.get("attention_stage_hm", 0)


CALL_HK = (3, 2)  # a per-call H and K other than the Eval config's


def phase_call_args(torch, record, d3dp, x2d, x2d_f):
    """`D3DP.sample(..., num_proposals=, sampling_timesteps=)`: the Eval
    config's sampler (H=K=5) called at CALL_HK on injected noise, at fuse
    levels 4 and 5, equal bit for bit to a sampler configured with that H
    and K on the same model and noise, with that call's launches (K1 and K2
    2 x depth x K at level 4, K9 K at level 5)."""
    from d3dp_tpu_torch.diffusion import D3DP

    h, k = CALL_HK
    fixed = D3DP(dataclasses.replace(d3dp.cfg, num_proposals=h, sampling_timesteps=k),
                 model=d3dp.model)
    g = torch.Generator(device="cuda").manual_seed(60)
    noise = (torch.randn(B, h, F, J, 3, generator=g, device="cuda"),
             torch.randn(k, B, h, F, J, 3, generator=g, device="cuda"))
    out = {}
    for level in (4, 5):
        set_level(d3dp.model, level)
        reset_counts()
        got = d3dp.sample(x2d, x2d_f, noise_override=noise, num_proposals=h,
                          sampling_timesteps=k)
        torch.cuda.synchronize()
        counts = {n: c for n, c in read_counts().items() if c}
        want = {n: per_forward(level) * k for n in LEVEL_KERNELS[level]}
        equal = torch.equal(got, fixed.sample(x2d, x2d_f, noise_override=noise))
        ok = (tuple(got.shape) == (B, k, h, F, J, 3) and bool(torch.isfinite(got).all())
              and equal and counts == want)
        log(f"[call_args] D3DP.sample(num_proposals={h}, sampling_timesteps={k}) on the "
            f"H={H}, K={K} sampler at level {level}: shape {tuple(got.shape)}, equal to a "
            f"sampler configured with H={h}, K={k} {equal}; launches {counts} (expected "
            f"{want}) {'ok' if ok else 'FAIL'}")
        check(ok, f"D3DP.sample at a per-call H and K at level {level}: differs from a "
              "configured sampler, or launch counts")
        out[level] = dict(launches=counts, equal=equal)
    set_level(d3dp.model, 4)
    record["call_args"] = out


def phase_public_dp(torch, record):
    """The row-form MLP kernel's DropPath form (K5-dp) has no model path (the
    level-4 flow runs the transposing form); its path is its public op,
    `mlp_block_dp_ad` (the JAX `mlp_block_dp_p`), forward and backward once
    at the train step's spatial token rows, bf16."""
    from d3dp_tpu_torch.ops import mlp as M

    gen = torch.Generator(device="cuda").manual_seed(14)
    args = mlp_inputs(torch, gen, F, J, torch.bfloat16, BT)
    args[:2] = [a.view(-1, C).requires_grad_(True) for a in args[:2]]
    dp = dp_scales(torch, gen, (BT * F * J,))
    reset_counts()
    out = M.mlp_block_dp_ad(*args, dp, 1e-6)
    gx, gres = torch.autograd.grad(out, args[:2], torch.randn_like(out))
    torch.cuda.synchronize()
    n = read_counts()["mlp_block_dp"]
    finite = all(bool(torch.isfinite(v).all()) for v in (out, gx, gres))
    ok = n == 1 and finite
    log(f"[public-dp] mlp_block_dp_ad bf16 rows{tuple(out.shape)} forward + backward: launches "
        f"{n} (expected 1), finite {finite} {'ok' if ok else 'FAIL'}")
    check(ok, "mlp_block_dp_ad did not launch its kernel, or non-finite")
    record["launches"]["mlp_block_dp"] = n


# ------------------------------------------------------------- lab switches
# Each switch instantiation of a kernel: name -> (the environment that
# selects it, the line of the TPU kernel's switch it replaces)
LAB = {
    "attention_stage[fold0]": ({"D3DP_SOFTMAX_FOLD": "0"}, "d3dp_tpu/ops/attention.py:432"),
    "attention_stage[bf16exp]": ({"D3DP_ATTN_VARIANT": "bf16exp"},
                                 "d3dp_tpu/ops/attention.py:593"),
    "attention_stage[noy2]": ({"D3DP_ATTN_VARIANT": "noy2"}, "d3dp_tpu/ops/attention.py:468"),
    "attention_stage[group8]": ({"D3DP_SPATIAL_GROUP": "8"}, "d3dp_tpu/ops/attention.py:434"),
    "attention_stage[group15]": ({"D3DP_SPATIAL_GROUP": "15"}, "d3dp_tpu/ops/attention.py:434"),
    "attention_stage[group18]": ({"D3DP_SPATIAL_GROUP": "18"}, "d3dp_tpu/ops/attention.py:434"),
    "attention_stage_dp[fold0]": ({"D3DP_SOFTMAX_FOLD": "0"}, "d3dp_tpu/ops/attention.py:432"),
    "attention_stage_dp[bf16exp]": ({"D3DP_ATTN_VARIANT": "bf16exp"},
                                    "d3dp_tpu/ops/attention.py:593"),
    "attention_stage_hm[fold0]": ({"D3DP_SOFTMAX_FOLD": "0", "D3DP_ATTN_VARIANT": "hmqkv"},
                                  "d3dp_tpu/ops/attention.py:544"),
    "mlp_block_t[bf16gelu]": ({"D3DP_MLP_VARIANT": "bf16gelu"}, "d3dp_tpu/ops/mlp.py:69"),
    "mlp_block_t[nogelu]": ({"D3DP_MLP_VARIANT": "nogelu"}, "d3dp_tpu/ops/mlp.py:67"),
    "mlp_block[bf16gelu]": ({"D3DP_MLP_VARIANT": "bf16gelu"}, "d3dp_tpu/ops/mlp.py:69"),
    "mlp_block[nogelu]": ({"D3DP_MLP_VARIANT": "nogelu"}, "d3dp_tpu/ops/mlp.py:67"),
    "mlp_block_t_dp[bf16gelu]": ({"D3DP_MLP_VARIANT": "bf16gelu"}, "d3dp_tpu/ops/mlp.py:69"),
    "mlp_block_t_dp[nogelu]": ({"D3DP_MLP_VARIANT": "nogelu"}, "d3dp_tpu/ops/mlp.py:67"),
    "mlp_block_dp[bf16gelu]": ({"D3DP_MLP_VARIANT": "bf16gelu"}, "d3dp_tpu/ops/mlp.py:69"),
    "mlp_block_dp[nogelu]": ({"D3DP_MLP_VARIANT": "nogelu"}, "d3dp_tpu/ops/mlp.py:67"),
    "resident_block_stack[fold0]": ({"D3DP_SOFTMAX_FOLD": "0"}, "d3dp_tpu/ops/resident.py:229"),
    "resident_block_stack[bf16exp]": ({"D3DP_ATTN_VARIANT": "bf16exp"},
                                      "d3dp_tpu/ops/resident.py:231"),
    "resident_block_stack[bf16gelu]": ({"D3DP_MLP_VARIANT": "bf16gelu"},
                                       "d3dp_tpu/ops/mlp.py:69"),
    "resident_block_stack[nogelu]": ({"D3DP_MLP_VARIANT": "nogelu"}, "d3dp_tpu/ops/mlp.py:67"),
}


@contextlib.contextmanager
def env_vars(settings):
    """Set several environment variables for a block."""
    with contextlib.ExitStack() as stack:
        for name, value in settings.items():
            stack.enter_context(env_var(name, value))
        yield


def level4_chain(R, A, M, args):
    """The trunk on args through the level-4 kernels (`attention_stage`,
    `mlp_block_t`, each reading the switches itself), in the loop of
    `resident_block_stack_plain`."""
    saved = R.attention_stage_plain, R.mlp_block_t_plain
    R.attention_stage_plain = lambda *a, opts=0: A.attention_stage(*a)
    R.mlp_block_t_plain = lambda *a, gelu=0: M.mlp_block_t(*a)
    try:
        return R.resident_block_stack_plain(*args, HEADS, 0.125, 1e-6)
    finally:
        R.attention_stage_plain, R.mlp_block_t_plain = saved


def lab_kernels(torch, rows, errs):
    """Each switch instantiation against its plain version with the same
    options, at the shapes of its path (K1, K2, K5, K8, K9: eval, 40
    hypothesis rows, K9 at depth 1; K1-dp, K2-dp, K5-dp: train), bf16, and
    fp32 where the switch applies there (noy2, grouping, nogelu): K1/K2's
    bands, 3e-2 plus one bf16 ulp in bf16 and 1e-4 in fp32. noy2's x2 must
    equal production K1's, K8 under fold0 K1 under fold0, and grouped K1 in
    fp32 ungrouped K1 too (1e-4). K9 at depth 1 (two chained blocks, where
    a bf16 rounding flip compounds past K1/K2's band over the 40 rows) must
    equal the level-4 kernels under the switch bit for bit (each held above)
    and lie within one bf16 ulp (2^-7) of its plain version in relative L2;
    the depth-1 probe holds it to the band on 2 rows. Then each is timed in bf16 beside its
    plain version (with the same options) and, where library calls
    compute the same function, those: for fold0 (its softmax normalised
    after P @ V, the same function) and the grouped stage the library stage
    (K1, K1-dp, K8) or trunk (K9), for noy2 the library stage without LN2,
    for bf16gelu the library MLP (F.linear, GELU on the bf16 hidden
    activations, F.linear, the residual, layer_norm) or trunk, for nogelu
    the library MLP or trunk without GELU; no PyTorch call computes bf16exp's
    function (exp rounded to bf16 inside the softmax). Bounds are those of
    the kernel the switch modifies."""
    import torch.nn.functional as Fn
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M
    from d3dp_tpu_torch.ops import resident as R

    gen = torch.Generator(device="cuda").manual_seed(60)
    bf, f32 = torch.bfloat16, torch.float32
    sc = 0.125

    def held(name, label, dt, pairs, equal=True):
        torch.cuda.synchronize()
        ulp = BF16_ULP if dt == bf else 0.0
        tol = TOL[str(dt).split(".")[1]]
        es = [max_err(torch, g, w, ulp) for g, w in pairs]
        ok = all(ex <= tol for _, ex in es) and equal
        log(f"[lab] {name} {label} {str(dt)[6:]}: max|err| {' / '.join(f'{e:.3e}' for e, _ in es)} "
            f"(tol {tol:g}{' + 1 bf16 ulp' if ulp else ''}){'' if equal is True else ', equal'} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{name} {label} {dt} disagrees with its plain version")
        if dt == bf:
            errs[name] = max(errs.get(name, 0.0), *(e for e, _ in es))

    def timed(name, label, shape, run, plain, flops, nbytes, lib=None):
        with env_vars(LAB[name][0]):
            rows[f"{name}/{label}"] = dict(
                shape=list(shape), flops=flops, bytes=nbytes, ms=time_ms(torch, run, reps=5),
                plain_ms=time_ms(torch, plain, reps=2),
                library_ms=None if lib is None else time_ms(torch, lib, reps=5))

    def lib_stage_args(a):
        return [a[0], a[1].t().contiguous(), a[2].to(bf), a[3].t().contiguous(),
                a[4].to(bf)] + [v.to(bf) for v in a[5:]]

    def lib_mlp_args(a):
        return [a[0], a[1], a[2].t().contiguous(), a[3].to(bf), a[4].t().contiguous(),
                a[5].to(bf), a[6].to(bf), a[7].to(bf)]

    lib_a, lib_a_x2 = library_attention(torch, Fn), library_attention(torch, Fn, with_y2=False)
    stage_opts = {"fold0": A.OPT_NORM_FIRST, "bf16exp": A.OPT_BF16_EXP, "noy2": A.OPT_NO_Y2}
    for label, Rr, N in (("spatial", ROWS * F, J), ("temporal", ROWS * J, F)):
        T = Rr * N
        flops = 2 * T * C * 3 * C + 4 * T * N * C + 2 * T * C * C
        nbytes = 3 * T * C * 2 + 4 * C * C * 2 + 8 * C * 4
        for dt in (f32, bf):
            a = stage_inputs(torch, gen, Rr, N, dt)
            base = A.attention_stage(*a, HEADS, sc, 1e-6)
            for sw, opt in stage_opts.items():
                if dt == f32 and sw != "noy2":
                    continue
                name = f"attention_stage[{sw}]"
                with env_vars(LAB[name][0]):
                    got = A.attention_stage(*a, HEADS, sc, 1e-6)
                want = A.attention_stage_plain(*a, HEADS, sc, 1e-6, opts=opt)
                if sw == "noy2":
                    held(name, label, dt, [(got[0], want[0])], torch.equal(got[0], base[0]))
                else:
                    held(name, label, dt, list(zip(got, want)))
                if dt == bf:
                    la = lib_stage_args(a)
                    timed(name, label, a[0].shape,
                          lambda: A.attention_stage(*a, HEADS, sc, 1e-6),
                          lambda opt=opt: A.attention_stage_plain(*a, HEADS, sc, 1e-6, opts=opt),
                          flops, nbytes - (T * C * 2 if sw == "noy2" else 0),
                          {"noy2": lambda: lib_a_x2(*la), "fold0": lambda: lib_a(*la)}.get(sw))
                del got, want
            if label == "spatial":
                la = lib_stage_args(a) if dt == bf else None
                for g in (8, 15, 18):
                    name = f"attention_stage[group{g}]"
                    with env_vars(LAB[name][0]):
                        got = A.attention_stage(*a, HEADS, sc, 1e-6)
                    want = A.attention_stage_plain(a[0].view(Rr // g, g * N, C), *a[1:], HEADS,
                                                   sc, 1e-6, mask_block=N)
                    pairs = [(gv, w.view(Rr, N, C)) for gv, w in zip(got, want)]
                    held(name, label, dt, pairs + (list(zip(got, base)) if dt == f32 else []))
                    if dt == bf:
                        timed(name, label, a[0].shape,
                              lambda: A.attention_stage(*a, HEADS, sc, 1e-6),
                              lambda g=g: A.attention_stage_plain(
                                  a[0].view(Rr // g, g * N, C), *a[1:], HEADS, sc, 1e-6,
                                  mask_block=N),
                              flops, nbytes, lambda: lib_a(*la))
                    del got, want
            if dt == bf:
                name = "attention_stage_hm[fold0]"
                hm = [a[0], *A.stack_head_major(a[1], a[2], HEADS), *a[3:]]
                with env_vars(LAB[name][0]):
                    got = A.attention_stage_hm(*hm, HEADS, sc, 1e-6)
                with env_vars(LAB["attention_stage[fold0]"][0]):
                    k1 = A.attention_stage(*a, HEADS, sc, 1e-6)
                want = A.attention_stage_hm_plain(*hm, HEADS, sc, 1e-6, opts=A.OPT_NORM_FIRST)
                held(name, label, dt, list(zip(got, want)),
                     all(torch.equal(g_, k_) for g_, k_ in zip(got, k1)))
                la = lib_stage_args(a)
                timed(name, label, a[0].shape, lambda: A.attention_stage_hm(*hm, HEADS, sc, 1e-6),
                      lambda: A.attention_stage_hm_plain(*hm, HEADS, sc, 1e-6,
                                                         opts=A.OPT_NORM_FIRST), flops, nbytes,
                      lambda: lib_a(*la))
                del got, k1, want, hm
            del a, base
    for label, Rr, N in TRAIN_SHAPES:
        T = Rr * N
        flops = 2 * T * C * 3 * C + 4 * T * N * C + 2 * T * C * C
        nbytes = 3 * T * C * 2 + 4 * C * C * 2 + 8 * C * 4 + Rr * 4
        a = stage_inputs(torch, gen, Rr, N, bf)
        dp = dp_scales(torch, gen, (Rr,))
        la, dpb = lib_stage_args(a), dp.to(bf)
        for sw in ("fold0", "bf16exp"):
            name = f"attention_stage_dp[{sw}]"
            opt = stage_opts[sw]
            with env_vars(LAB[name][0]):
                got = A.attention_stage_dp(*a, dp, HEADS, sc, 1e-6)
            held(name, f"train {label}", bf, list(zip(got, A.attention_stage_dp_plain(
                *a, dp, HEADS, sc, 1e-6, opts=opt))))
            timed(name, label, a[0].shape,
                  lambda: A.attention_stage_dp(*a, dp, HEADS, sc, 1e-6),
                  lambda opt=opt: A.attention_stage_dp_plain(*a, dp, HEADS, sc, 1e-6, opts=opt),
                  flops, nbytes, (lambda: lib_a(*la, dp=dpb)) if sw == "fold0" else None)
        del a, dp, la, dpb

    gelus = {"bf16gelu": M.GELU_BF16, "nogelu": M.GELU_NONE}
    libs = {(t, act): library_mlp(torch, Fn, transpose=t, act=act)
            for t in (True, False) for act in (True, False)}
    for label, n_rows, D1, D2 in MLP_SHAPES:
        T = n_rows * D1 * D2
        flops = 4 * T * C * HIDDEN
        nbytes = 3 * T * C * 2 + 2 * C * HIDDEN * 2 + (HIDDEN + 3 * C) * 4
        train = label.startswith("train")
        for dt in ((bf,) if train or D1 == J else (f32, bf)):
            a = mlp_inputs(torch, gen, D1, D2, dt, n_rows)
            r = [t.view(-1, C) for t in a[:2]] + a[2:]
            dp = dp_scales(torch, gen, (n_rows, D1)) if train else None
            dpr = dp_scales(torch, gen, (T,)) if train else None
            forms = [("mlp_block_t_dp" if train else "mlp_block_t", a, dp, True)]
            if D1 == F:  # the rows form on the spatial->temporal token rows
                forms.append(("mlp_block_dp" if train else "mlp_block", r, dpr, False))
            for sw, gelu in gelus.items():
                if dt == f32 and sw == "bf16gelu":
                    continue
                for base_name, args, scales, t in forms:
                    name = f"{base_name}[{sw}]"
                    op = getattr(M, base_name)
                    plain = M.mlp_block_t_plain if t else M.mlp_block_plain
                    extra = () if scales is None else (scales,)
                    with env_vars(LAB[name][0]):
                        got = op(*args, *extra, 1e-6)
                    held(name, label if t else f"{label.split()[0]} rows", dt,
                         [(got, plain(*args, 1e-6, scales, gelu=gelu))])
                    if dt == bf:
                        lib = libs[t, sw != "nogelu"]
                        la = lib_mlp_args(args)
                        ls = None if scales is None else scales.to(bf)
                        timed(name, label.split()[1] if t else "rows", args[0].shape,
                              lambda op=op, args=args, extra=extra: op(*args, *extra, 1e-6),
                              lambda plain=plain, args=args, scales=scales, gelu=gelu: plain(
                                  *args, 1e-6, scales, gelu=gelu),
                              flops, nbytes + (0 if scales is None else scales.numel() * 4),
                              lambda lib=lib, la=la, ls=ls: lib(*la, dp=ls))
                    del got
            del a, r, dp, dpr

    x, tpos, sp, tp, shared = resident_inputs(torch, bf, 30)
    one = (x, tpos, tuple(w[:1] for w in sp), tuple(w[:1] for w in tp), shared)
    full = (x, tpos, sp, tp, shared)
    flops, nbytes = resident_flops_bytes(x, DEPTH)
    for sw in ("fold0", "bf16exp", "bf16gelu", "nogelu"):
        name = f"resident_block_stack[{sw}]"
        with env_vars(LAB[name][0]):
            opts, gelu = R.resident_options(bf)
            got = R.resident_block_stack(*one, HEADS, sc, 1e-6)
            chain = level4_chain(R, A, M, one)
        want = R.resident_block_stack_plain(*one, HEADS, sc, 1e-6, opts=opts, gelu=gelu)
        torch.cuda.synchronize()
        e = (got.float() - want.float()).abs().max().item()
        rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
        equal = torch.equal(got, chain)
        ok = equal and rel <= BF16_ULP
        log(f"[lab] {name} x{tuple(x.shape)} depth 1 bf16: equal to the level-4 kernels under "
            f"the switch {equal}; vs plain max|err| {e:.3e}, relative L2 {rel:.3e} (tol one "
            f"bf16 ulp, {BF16_ULP:g}) {'ok' if ok else 'FAIL'}")
        check(ok, f"{name} differs from the level-4 kernels or from its plain version")
        errs[name] = e
        del got, chain, want
        lib = None if sw == "bf16exp" else library_trunk(torch, Fn, *full, act=sw != "nogelu")
        with env_vars(LAB[name][0]):
            rows[f"{name}/trunk"] = dict(
                shape=list(x.shape), flops=flops, bytes=nbytes,
                ms=time_ms(torch, lambda: R.resident_block_stack(*full, HEADS, sc, 1e-6), reps=2),
                plain_ms=time_ms(torch, lambda opts=opts, gelu=gelu: R.resident_block_stack_plain(
                    *full, HEADS, sc, 1e-6, opts=opts, gelu=gelu), reps=1),
                library_ms=None if lib is None else time_ms(torch, lib, reps=3))
        del lib
    for key, r in rows.items():
        if "[" in key:
            r["bound_ms"], r["bound_by"] = bound_ms(r["flops"], r["bytes"], PEAK_BF16)
            lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
            log(f"[lab-timing] {key} bf16 x{tuple(r['shape'])}: kernel {r['ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
                f"library {lib}")


def group_rows_fp32(torch, Fn):
    """Grouped K1 (`D3DP_SPATIAL_GROUP` = 8, 15, 18) in fp32, the default
    dtype, at the eval path's spatial shape beside ungrouped fp32 K1: each
    timed (CUDA events) with its launches' device times (`launch_split`),
    its plain version, the fp32 library stage (ungrouped, the same
    function; TF32 off), its bound at the three-pass TF32 rate and its
    attend launch's bound (bytes: qkv read, o written). The TF32 planes are
    made outside the timed calls, as the model's weight cache makes them."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import tf32

    check(not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32),
          "TF32 is on for the fp32 library calls")
    gen = torch.Generator(device="cuda").manual_seed(61)
    Rr, N = ROWS * F, J
    T = Rr * N
    a = stage_inputs(torch, gen, Rr, N, torch.float32)
    pa = (tf32.planes(a[1]), tf32.planes(a[3]))
    lib_a = library_attention(torch, Fn)
    lib_args = [a[0], a[1].t().contiguous(), a[2], a[3].t().contiguous(), *a[4:]]
    lib_ms = time_ms(torch, lambda: lib_a(*lib_args), reps=5)
    flops = 2 * T * C * 3 * C + 4 * T * N * C + 2 * T * C * C
    nbytes = 3 * T * C * 4 + 4 * C * C * 4 + 8 * C * 4
    out = {}
    for g in (0, 8, 15, 18):
        name = f"attention_stage[group{g}]" if g else "attention_stage"
        with env_vars(LAB[name][0] if g else {}):
            k1 = lambda: A.attention_stage(*a, HEADS, 0.125, 1e-6, planes=pa)
            r = out[f"{name}/spatial"] = dict(
                shape=list(a[0].shape), flops=flops, bytes=nbytes, ms=time_ms(torch, k1, reps=5),
                plain_ms=time_ms(torch, lambda: A.attention_stage_plain(
                    a[0].view(Rr // max(g, 1), max(g, 1) * N, C), *a[1:], HEADS, 0.125, 1e-6,
                    mask_block=N if g else 0), reps=2),
                library_ms=lib_ms, attend_bound_ms=1e3 * 4 * T * C * 4 / HBM)
            r["launches_ms"] = launch_split(torch, k1, r["ms"])
        r["bound_ms"], r["bound_by"] = bound_ms(flops, nbytes, PEAK_TF32 / 3)
        log(f"[lab-timing] {name}/spatial fp32 x{tuple(r['shape'])}: kernel {r['ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, three TF32 passes; attend launch "
            f"{r['attend_bound_ms']:.4f} ms, bytes), plain {r['plain_ms']:.4f} ms, library "
            f"(ungrouped, TF32 off) {r['library_ms']:.4f} ms" + launches_text(r))
    return out


def phase_lab_switches(torch, record, d3dp, x2d, x2d_f, rows):
    """The lab switches on their paths. Kernels: `lab_kernels`. Paths, bf16
    at the eval and train configs, counts set to 0 before each run:
    D3DP.sample at level 4 in production and under fold0, bf16exp, group 8,
    bf16gelu and nogelu, each timed (median of 2 after a warm-up call), with
    80 K1 + 80 K2 launches; untimed under group 15 and 18; under hmqkv with
    fold0 (80 K8, equal to the fold0 call with K1); at level 5 under fold0,
    bf16exp, bf16gelu and nogelu (5 K9 each, equal to level 4's call under
    the same switch bit for bit; bf16exp and bf16gelu timed); at level 1
    under bf16gelu and nogelu (80 K5); one D3DP_TRAIN_FUSED=1 step at level
    4 under fold0, bf16exp, bf16gelu and nogelu (14 K1-dp or K2-dp each);
    `mlp_block_dp_ad` under bf16gelu and nogelu (1 K5-dp each); noy2 by its
    public op at the two eval stage shapes (its model output is undefined:
    y2 is never written). Returns the errors and the launches per
    instantiation."""
    import torch.nn.functional as Fn

    from d3dp_tpu_torch.diffusion import D3DP
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M
    from d3dp_tpu_torch.train.state import make_optimizer, make_train_step

    t0 = time.perf_counter()
    errs, launches, out = {}, {}, {}
    lab_kernels(torch, rows, errs)
    out["kernel_rows_fp32"] = group_rows_fp32(torch, Fn)

    def sample(tag, settings, level, seed, reps, want):
        set_level(d3dp.model, level)
        with env_vars(settings):
            reset_counts()
            res = d3dp.sample(x2d, x2d_f, generator=torch.Generator(device="cuda").manual_seed(seed))
            torch.cuda.synchronize()
            counts = {n: c for n, c in read_counts().items() if c}
            g = torch.Generator(device="cuda").manual_seed(seed)
            ms = time_ms(torch, lambda: d3dp.sample(x2d, x2d_f, generator=g), reps) if reps else None
        ok = counts == want and bool(torch.isfinite(res).all())
        log(f"[lab] D3DP.sample B={B} H={H} K={K} F={F} bf16 level {level} {tag}: "
            + (f"{ms / 1e3:.4f} s/call (median of {reps}), "
               f"{B * H * F * K * 1e3 / ms:.1f} hyp*frames/s; " if ms else "")
            + f"launches {counts} (expected {want}) {'ok' if ok else 'FAIL'}")
        check(ok, f"D3DP.sample at level {level} under {tag}: launch counts or non-finite output")
        out[f"sample L{level} {tag}"] = dict(sample_s=None if ms is None else ms / 1e3,
                                             launches=counts)
        return res, counts

    l4 = {"attention_stage": 2 * DEPTH * K, "mlp_block_t": 2 * DEPTH * K}
    prod, _ = sample("production", {}, 4, 70, 2, l4)
    at4 = {}
    for tag, settings in (("fold0", {"D3DP_SOFTMAX_FOLD": "0"}),
                          ("bf16exp", {"D3DP_ATTN_VARIANT": "bf16exp"}),
                          ("group8", {"D3DP_SPATIAL_GROUP": "8"}),
                          ("group15", {"D3DP_SPATIAL_GROUP": "15"}),
                          ("group18", {"D3DP_SPATIAL_GROUP": "18"}),
                          ("bf16gelu", {"D3DP_MLP_VARIANT": "bf16gelu"}),
                          ("nogelu", {"D3DP_MLP_VARIANT": "nogelu"})):
        at4[tag], counts = sample(tag, settings, 4, 70, 0 if tag in ("group15", "group18") else 2,
                                  l4)
        out[f"sample L4 {tag}"]["max_abs_diff_vs_production"] = \
            (at4[tag] - prod).abs().max().item()
        for kind in ("attention_stage", "mlp_block_t"):
            if f"{kind}[{tag}]" in LAB:
                launches[f"{kind}[{tag}]"] = counts.get(kind, 0)
    hm, counts = sample("hmqkv fold0", LAB["attention_stage_hm[fold0]"][0], 4, 70, 0,
                        {"attention_stage_hm": 2 * DEPTH * K, "mlp_block_t": 2 * DEPTH * K})
    check(torch.equal(hm, at4["fold0"]), "K8 under fold0 differs from K1 under fold0")
    launches["attention_stage_hm[fold0]"] = counts.get("attention_stage_hm", 0)
    for tag in ("fold0", "bf16exp", "bf16gelu", "nogelu"):
        name = f"resident_block_stack[{tag}]"
        res, counts = sample(tag, LAB[name][0], 5, 70, 2 if tag in ("bf16exp", "bf16gelu") else 0,
                             {"resident_block_stack": K})
        equal = torch.equal(res, at4[tag])
        log(f"[lab] level 5 vs level 4 under {tag}: max|diff| "
            f"{(res - at4[tag]).abs().max().item():.3e}, equal {equal} {'ok' if equal else 'FAIL'}")
        check(equal, f"level 5 differs from level 4 under {tag}")
        launches[name] = counts.get("resident_block_stack", 0)
    for tag in ("bf16gelu", "nogelu"):
        _, counts = sample(tag, LAB[f"mlp_block[{tag}]"][0], 1, 70, 0,
                           {"fused_attention_qkv": 2 * DEPTH * K, "mlp_block": 2 * DEPTH * K})
        launches[f"mlp_block[{tag}]"] = counts.get("mlp_block", 0)
    set_level(d3dp.model, 4)

    # the train-fused path: one step under each switch that reaches K1-dp or K2-dp
    train = D3DP(train_config(torch), seed=0)
    step = make_train_step(train, make_optimizer(train.model.parameters(), 6e-5))
    g = torch.Generator(device="cuda").manual_seed(71)
    b2d = torch.randn(BT, F, J, 2, generator=g, device="cuda") * 0.3
    b3d = torch.randn(BT, F, J, 3, generator=g, device="cuda") * 0.3
    want = train_fused_counts(4, DEPTH)
    for tag, name in (("fold0", "attention_stage_dp[fold0]"),
                      ("bf16exp", "attention_stage_dp[bf16exp]"),
                      ("bf16gelu", "mlp_block_t_dp[bf16gelu]"),
                      ("nogelu", "mlp_block_t_dp[nogelu]")):
        with env_vars({**LAB[name][0], "D3DP_TRAIN_FUSED": "1"}):
            reset_counts()
            loss = step(b2d, b3d, torch.ones(BT, device="cuda"), generator=g)
            torch.cuda.synchronize()
            counts = {n: c for n, c in read_counts().items() if c}
        ok = counts == want and math.isfinite(loss.item())
        log(f"[lab] D3DP_TRAIN_FUSED=1 step, batch {BT}x{F}, bf16, level 4 under {tag}: loss "
            f"{loss.item():.4f}; launches {counts} {'ok' if ok else 'FAIL'}")
        check(ok, f"train-fused step under {tag}: launch counts or non-finite loss")
        launches[name] = counts.get(name.split("[")[0], 0)
    del train, step

    # K5-dp through its public op, and noy2 through the stage op
    gen = torch.Generator(device="cuda").manual_seed(72)
    a = mlp_inputs(torch, gen, F, J, torch.bfloat16, BT)
    a[:2] = [v.view(-1, C).requires_grad_(True) for v in a[:2]]
    dp = dp_scales(torch, gen, (BT * F * J,))
    for tag in ("bf16gelu", "nogelu"):
        with env_vars(LAB[f"mlp_block_dp[{tag}]"][0]):
            reset_counts()
            y = M.mlp_block_dp_ad(*a, dp, 1e-6)
            grads = torch.autograd.grad(y, a[:2], torch.randn_like(y))
            torch.cuda.synchronize()
        n = read_counts()["mlp_block_dp"]
        ok = n == 1 and all(bool(torch.isfinite(v).all()) for v in (y, *grads))
        log(f"[lab] mlp_block_dp_ad under {tag} forward + backward: launches {n} "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"mlp_block_dp_ad under {tag}: launches or non-finite")
        launches[f"mlp_block_dp[{tag}]"] = n
    reset_counts()
    with env_vars(LAB["attention_stage[noy2]"][0]):
        for Rr, N in ((ROWS * F, J), (ROWS * J, F)):
            x2, _ = A.attention_stage(*stage_inputs(torch, gen, Rr, N, torch.bfloat16), HEADS,
                                      0.125, 1e-6)
            check(bool(torch.isfinite(x2).all()), "noy2: non-finite x2")
    torch.cuda.synchronize()
    launches["attention_stage[noy2]"] = read_counts()["attention_stage"]
    check(launches["attention_stage[noy2]"] == 2, "noy2: the stage op did not launch K1")
    out["seconds"] = time.perf_counter() - t0
    log(f"[lab] phase lab_switches: {out['seconds']:.1f} s")
    record["lab_switches"] = out
    return errs, launches


def summarize_profile(torch, prof, wall_ms, what, tag, top=12):
    """Log and return the device kernels' time by name (device-side events
    only: an aten op's own entry repeats the device time of its kernels, and
    a user annotation such as `Optimizer.step` spans them again)."""
    kernels = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                      for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and e.self_device_time_total > 0), key=lambda k: -k[2])
    if not kernels:
        log(f"[{tag}] {what}: wall {wall_ms:.1f} ms (profiled); the profiler recorded no "
            f"device kernels, device busy time not measured")
        return dict(wall_ms=wall_ms, device_busy_ms=None)
    busy = sum(ms for _, _, ms in kernels)
    log(f"[{tag}] {what}: wall {wall_ms:.1f} ms (profiled), device busy {busy:.1f} ms "
        f"({100 * busy / wall_ms:.1f}%), idle {100 * (1 - busy / wall_ms):.1f}%")
    for name, n, ms in kernels[:top]:
        log(f"[{tag}]   {100 * ms / busy:5.1f}%  {ms:9.3f} ms  x{n:<4d} {name[:90]}")
    return dict(wall_ms=wall_ms, device_busy_ms=busy,
                top=[[k[:120], n, ms] for k, n, ms in kernels[:top]])


def attend_split(torch, prof):
    """Device ms of the attend launches in a profile: the short tile's
    (spatial, N = 17) and the tensor-core tile's (temporal, N = 243)."""
    out = {"spatial": 0.0, "temporal": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for kind, key in (("spatial", "attend_short"), ("temporal", "attend_mma")):
            if key in e.key:
                out[kind] += e.self_device_time_total / 1e3
    return out


def phase_profile(torch, record, d3dp, x2d, x2d_f):
    """Where one D3DP.sample call's device time goes, by kernel
    (torch.profiler over a warm call), and the attend launches' share of it
    split into spatial and temporal."""
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(4)
    d3dp.sample(x2d, x2d_f, generator=g)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        d3dp.sample(x2d, x2d_f, generator=g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    record["profile"] = summarize_profile(torch, prof, wall_ms, "one D3DP.sample call",
                                          "profile")
    busy = record["profile"]["device_busy_ms"]
    if busy:
        split = attend_split(torch, prof)
        record["profile"]["attend_ms"] = split
        log("[profile] attend launches: " + "; ".join(
            f"{k} {ms:.3f} ms ({100 * ms / busy:.1f}% of busy)" for k, ms in split.items()))


def library_attention(torch, Fn, with_y2=True):
    """layer_norm, F.linear, SDPA, F.linear, the residual (its branch scaled
    by dp where given) and, with_y2, layer_norm (the yardstick of K1, K1-dp,
    K8; without y2, of K1 under noy2)."""
    def run(x, wqkv_t, bqkv, wp_t, bp, l1s, l1b, l2s, l2b, dp=None):
        R, N, _ = x.shape
        y1 = Fn.layer_norm(x, (C,), l1s, l1b, 1e-6)
        qkv = Fn.linear(y1, wqkv_t, bqkv).view(R, N, 3, HEADS, C // HEADS)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        o = Fn.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(R, N, C)
        branch = Fn.linear(o, wp_t, bp)
        x2 = x + (branch if dp is None else branch * dp[:, None, None])
        return (x2, Fn.layer_norm(x2, (C,), l2s, l2b, 1e-6)) if with_y2 else x2
    return run


def library_mlp(torch, Fn, transpose=True, act=True):
    """F.linear, GELU (without act: none, nogelu's function), F.linear, the
    residual (its branch scaled by dp where given) and layer_norm (the
    yardstick of K5, K5-dp), then the relayout (of K2, K2-dp)."""
    def run(x, res, w1_t, b1, w2_t, b2, ls, lb, dp=None):
        h = Fn.linear(x, w1_t, b1)
        h = Fn.gelu(h) if act else h
        branch = Fn.linear(h, w2_t, b2)
        if dp is not None:
            branch = branch * dp.reshape(*dp.shape, *(1,) * (x.dim() - dp.dim()))
        y = Fn.layer_norm(res + branch, (C,), ls, lb, 1e-6)
        return y.transpose(1, 2).contiguous() if transpose else y
    return run


def library_block(torch, Fn):
    """SDPA on q/k/v views of the packed qkv, then F.linear, the residual
    and layer_norm (the yardstick of K6)."""
    def run(qkv, res, wp_t, bp, ls, lb):
        R, N, _ = qkv.shape
        q, k, v = qkv.view(R, N, 3, HEADS, C // HEADS).permute(2, 0, 3, 1, 4).unbind(0)
        o = Fn.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(R, N, C)
        x2 = res + Fn.linear(o, wp_t, bp)
        return x2, Fn.layer_norm(x2, (C,), ls, lb, 1e-6)
    return run


def library_packed(torch, Fn):
    """SDPA on (R, h, N, d) views of separate q, k, v (the yardstick of K7)."""
    def run(q, k, v):
        R, N, _ = q.shape
        heads = [t.view(R, N, HEADS, C // HEADS).transpose(1, 2) for t in (q, k, v)]
        return Fn.scaled_dot_product_attention(*heads).transpose(1, 2).reshape(R, N, C)
    return run


def library_attention_qkv(torch, Fn, qkv):
    """F.scaled_dot_product_attention on q/k/v views of the packed qkv, back
    to the packed (R, N, C) output (the yardstick of K3; its backward, of
    K4)."""
    R, N, _ = qkv.shape

    def run(x):
        q, k, v = x.view(R, N, 3, HEADS, C // HEADS).permute(2, 0, 3, 1, 4).unbind(0)
        return Fn.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(R, N, C)
    return run


def phase_timing(torch, record, d3dp, x2d, x2d_f):
    import torch.nn.functional as Fn
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M

    g = torch.Generator(device="cuda").manual_seed(9)
    torch.cuda.reset_peak_memory_stats()
    sample_ms = time_ms(torch, lambda: d3dp.sample(x2d, x2d_f, generator=g), reps=5)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hfs = B * H * F * K / (sample_ms / 1e3)
    log(f"[timing] D3DP.sample B={B} H={H} K={K} F={F} bf16 flip-TTA: {sample_ms / 1e3:.4f} "
        f"s/call (median of 5), {hfs:.1f} hyp*frames/s, peak memory {peak_gb:.2f} GB")
    record.update(sample_seconds=sample_ms / 1e3, hyp_frames_per_s=hfs, sample_peak_gb=peak_gb)

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = {}
    lib_a, lib_m = library_attention(torch, Fn), library_mlp(torch, Fn)
    for label, R, N in (("spatial", ROWS * F, J), ("temporal", ROWS * J, F)):
        a = stage_inputs(torch, gen, R, N, bf)
        T = R * N
        flops = 2 * T * C * 3 * C + 4 * T * N * C + 2 * T * C * C
        nbytes = 3 * T * C * 2 + 4 * C * C * 2 + 8 * C * 4
        lib_args = [a[0], a[1].t().contiguous(), a[2].to(bf), a[3].t().contiguous(),
                    a[4].to(bf)] + [v.to(bf) for v in a[5:]]
        # the three-launch split writes qkv and o and reads them back, and
        # reads x a second time: extra device-memory bytes over one pass
        extra = T * (3 * C + 3 * C + C + C + C) * 2
        rows[f"attention_stage/{label}"] = dict(
            shape=list(a[0].shape), flops=flops, bytes=nbytes, split_extra_bytes=extra,
            ms=time_ms(torch, lambda: A.attention_stage(*a, HEADS, 0.125, 1e-6), reps=10),
            plain_ms=time_ms(torch, lambda: A.attention_stage_plain(*a, HEADS, 0.125, 1e-6),
                             reps=3),
            library_ms=time_ms(torch, lambda: lib_a(*lib_args), reps=10))
        del a, lib_args
    for label, D1, D2 in (("spatial->temporal", F, J), ("temporal->spatial", J, F)):
        a = mlp_inputs(torch, gen, D1, D2, bf)
        T = ROWS * D1 * D2
        flops = 4 * T * C * HIDDEN
        nbytes = 3 * T * C * 2 + 2 * C * HIDDEN * 2 + (HIDDEN + 3 * C) * 4
        lib_args = [a[0], a[1], a[2].t().contiguous(), a[3].to(bf), a[4].t().contiguous(),
                    a[5].to(bf), a[6].to(bf), a[7].to(bf)]
        rows[f"mlp_block_t/{label}"] = dict(
            shape=list(a[0].shape), flops=flops, bytes=nbytes,
            ms=time_ms(torch, lambda: M.mlp_block_t(*a, 1e-6), reps=10),
            plain_ms=time_ms(torch, lambda: M.mlp_block_t_plain(*a, 1e-6), reps=3),
            library_ms=time_ms(torch, lambda: lib_m(*lib_args), reps=10))
        del a, lib_args
    for label, R, N in TRAIN_SHAPES:
        qkv, dout = qkv_inputs(torch, gen, R, N, bf)
        T = R * N
        lib_fwd = library_attention_qkv(torch, Fn, qkv)
        leaf = qkv.clone().requires_grad_(True)
        lib_out = lib_fwd(leaf)
        # three medians in one run: the spread a K3 time carries
        k3_runs = [time_ms(torch, lambda: A.fused_attention_qkv(qkv, HEADS, 0.125), reps=20)
                   for _ in range(3)]
        rows[f"fused_attention_qkv/{label}"] = dict(
            shape=list(qkv.shape), flops=4 * T * N * C, bytes=(3 * C + C) * T * 2,
            ms=statistics.median(k3_runs), ms_runs=k3_runs,
            plain_ms=time_ms(torch, lambda: A.fused_attention_qkv_plain(qkv, HEADS, 0.125),
                             reps=5),
            library_ms=time_ms(torch, lambda: lib_fwd(qkv), reps=20))
        # S recomputed, dV, dP, dQ, dK: five N x N x d products per head
        rows[f"fused_attention_qkv_bwd/{label}"] = dict(
            shape=list(qkv.shape), flops=10 * T * N * C, bytes=(3 * C + C + 3 * C) * T * 2,
            ms=time_ms(torch, lambda: A.fused_attention_qkv_bwd(qkv, dout, HEADS, 0.125),
                       reps=20),
            plain_ms=time_ms(torch, lambda: A.fused_attention_qkv_bwd_plain(
                qkv, dout, HEADS, 0.125), reps=5),
            library_ms=time_ms(torch, lambda: torch.autograd.grad(
                lib_out, leaf, dout, retain_graph=True), reps=20))
        del qkv, dout, leaf, lib_out
    rows.update(eval_kernel_rows(torch, Fn, gen))
    rows.update(train_fused_kernel_rows(torch, Fn, gen))
    timing_fp32(torch, record, x2d, x2d_f, Fn, gen)
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r["flops"], r["bytes"], PEAK_BF16)
        log(f"[timing] {name} bf16 x{tuple(r['shape'])}: kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}; {r['flops'] / 1e9:.1f} GFLOP, "
            f"{r['bytes'] / 1e6:.1f} MB), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, {r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s"
            + (f", repeats {', '.join(f'{v:.4f}' for v in r['ms_runs'])} ms"
               if "ms_runs" in r else "")
            + (f", split costs {r['split_extra_bytes'] / 1e9:.3f} GB extra "
               f"({r['split_extra_bytes'] / HBM * 1e3:.3f} ms at full HBM rate)"
               if "split_extra_bytes" in r else ""))
    record["kernel_rows"] = rows
    return rows


# a stage call's launches: label -> the start of its `__global__`
# function's name (`launch_split`)
STAGE_KERNELS = {"ln_qkv": "ln_qkv", "attend": "attend", "proj": "proj"}


def launch_split(torch, fn, ms, kernels=STAGE_KERNELS, reps=5):
    """Device ms per call of each of fn's launches, by the name of its
    kernel's `__global__` function (`kernels`: label -> the name's start),
    from torch.profiler's device events over `reps` calls after two warm-up
    calls (the profiler's schedule); other kernels' events (a partial
    form's TF32 plane split) go under "other", the profiler's own step
    annotations nowhere. None, logged as not measured, where the profile is
    not whole: a label without exactly `reps` events, or events summing past
    fn's time per call from CUDA events (`ms`) by more than 5%."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=2, active=reps, repeat=1)) as prof:
        for _ in range(2 + reps):
            fn()
            torch.cuda.synchronize()
            prof.step()
    us, n = {}, {}
    for e in prof.events():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        name = re.match(r"(?:void\s+)?(?:\w+::)*(\w*)", e.name).group(1)
        label = next((k for k, start in kernels.items() if name.startswith(start)), "other")
        us[label] = us.get(label, 0.0) + e.time_range.elapsed_us()
        n[label] = n.get(label, 0) + 1
    out = {k: v / reps / 1e3 for k, v in us.items()}
    if all(n.get(k) == reps for k in kernels) and sum(out.values()) <= 1.05 * ms:
        return out
    log(f"[launch-split] not measured: events {n} over {reps} calls, device "
        f"{sum(out.values()):.4f} ms a call against {ms:.4f} ms from CUDA events")
    return None


def launches_text(r):
    """A row's launch split for the log."""
    if "launches_ms" not in r:
        return ""
    if r["launches_ms"] is None:
        return "; launches not measured"
    return "; launches " + ", ".join(f"{k} {v:.4f} ms" for k, v in r["launches_ms"].items())


def timing_fp32(torch, record, x2d, x2d_f, Fn, gen):
    """fp32, the default dtype of every entry point: one D3DP.sample at the
    eval config at fuse level 4 (launch counts, 3 timed calls, one profiled),
    then `fp32_kernel_rows`."""
    from torch.profiler import ProfilerActivity, profile

    from d3dp_tpu_torch.diffusion import D3DP
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M

    cfg = main_config(torch)
    d3dp = D3DP(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=torch.float32)), seed=0)
    perturb_(torch, d3dp.model, 1)
    g = torch.Generator(device="cuda").manual_seed(9)
    reset_counts()
    preds = d3dp.sample(x2d, x2d_f, generator=g)
    torch.cuda.synchronize()
    counts = (A.attention_stage.launches, M.mlp_block_t.launches)
    ok = bool(torch.isfinite(preds).all()) and counts == (2 * DEPTH * K, 2 * DEPTH * K)
    sample_ms = time_ms(torch, lambda: d3dp.sample(x2d, x2d_f, generator=g), reps=3)
    hfs = B * H * F * K / (sample_ms / 1e3)
    log(f"[timing] D3DP.sample B={B} H={H} K={K} F={F} fp32 flip-TTA level 4: "
        f"{sample_ms / 1e3:.4f} s/call (median of 3), {hfs:.1f} hyp*frames/s; launches "
        f"attention_stage {counts[0]} mlp_block_t {counts[1]} (expected 2*depth*K = "
        f"{2 * DEPTH * K}) {'ok' if ok else 'FAIL'}")
    check(ok, "fp32 D3DP.sample: non-finite output or launch counts")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        d3dp.sample(x2d, x2d_f, generator=g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    record.update(sample_seconds_fp32=sample_ms / 1e3, hyp_frames_per_s_fp32=hfs,
                  profile_fp32=summarize_profile(
                      torch, prof, wall_ms, "one fp32 D3DP.sample call at level 4",
                      "timing-fp32"))
    del d3dp, preds
    record["kernel_rows_fp32"] = fp32_kernel_rows(torch, Fn, gen)


def fp32_kernel_rows(torch, Fn, gen):
    """The fp32 forms at the bf16 rows' shapes: K1 (also split into its
    ln_qkv, attend and proj_ln2 launches), K8, K6, K1's attend launch alone,
    K7, K2 both ways, K5 on rows; K1-dp, K3 and K4 at the train step's shapes
    (K3's and K4's library calls SDPA's forward and backward); the matrices' TF32 planes attached
    outside the timed calls (as the model's weight cache attaches them), each with its
    plain version, the library calls in fp32 (TF32 off in both matmul and
    cuDNN), its bound at the three-pass TF32 rate and the FMA figure."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M
    from d3dp_tpu_torch.ops import tf32

    f32 = torch.float32
    tf32_on = torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32
    check(not tf32_on, "TF32 is on for the fp32 library calls")
    rows = {}
    lib_a, lib_m = library_attention(torch, Fn), library_mlp(torch, Fn)
    lib_b, lib_p = library_block(torch, Fn), library_packed(torch, Fn)

    def row(shape, flops, nbytes, run, plain, lib, **extra):
        return dict(shape=list(shape), flops=flops, bytes=nbytes, ms=time_ms(torch, run, reps=10),
                    plain_ms=time_ms(torch, plain, reps=3), library_ms=time_ms(torch, lib, reps=10),
                    **extra)

    for label, R, N in (("spatial", ROWS * F, J), ("temporal", ROWS * J, F)):
        T = R * N
        a = stage_inputs(torch, gen, R, N, f32)
        hm = [a[0], *A.stack_head_major(a[1], a[2], HEADS), *a[3:]]
        pa = (tf32.planes(a[1]), tf32.planes(a[3]))
        phm = (tf32.planes(hm[1]), pa[1])
        lib_args = [a[0], a[1].t().contiguous(), a[2], a[3].t().contiguous(), *a[4:]]
        flops = 2 * T * C * 3 * C + 4 * T * N * C + 2 * T * C * C
        nbytes = 3 * T * C * 4 + 4 * C * C * 4 + 8 * C * 4
        k1 = lambda: A.attention_stage(*a, HEADS, 0.125, 1e-6, planes=pa)
        r = rows[f"attention_stage/{label}"] = row(
            a[0].shape, flops, nbytes, k1, lambda: A.attention_stage_plain(*a, HEADS, 0.125, 1e-6),
            lambda: lib_a(*lib_args))
        r["launches_ms"] = launch_split(torch, k1, r["ms"])
        rows[f"attention_stage_hm/{label}"] = row(
            a[0].shape, flops, nbytes,
            lambda: A.attention_stage_hm(*hm, HEADS, 0.125, 1e-6, planes=phm),
            lambda: A.attention_stage_hm_plain(*hm, HEADS, 0.125, 1e-6), lambda: lib_a(*lib_args))
        del a, hm, lib_args, pa, phm
        b = block_inputs(torch, gen, R, N, f32)
        pb = (tf32.planes(b[2]),)
        lib_args = [b[0], b[1], b[2].t().contiguous(), *b[3:]]
        rows[f"attention_block/{label}"] = row(
            b[0].shape, 4 * T * N * C + 2 * T * C * C, 6 * T * C * 4 + C * C * 4 + 3 * C * 4,
            lambda: A.attention_block(*b, HEADS, 0.125, 1e-6, planes=pb),
            lambda: A.attention_block_plain(*b, HEADS, 0.125, 1e-6), lambda: lib_b(*lib_args))
        lib_q = library_attention_qkv(torch, Fn, b[0])
        rows[f"attend/{label}"] = row(
            b[0].shape, 4 * T * N * C, 4 * T * C * 4, lambda: A.attend_qkv(b[0], HEADS, 0.125),
            lambda: A.attend_qkv_plain(b[0], HEADS, 0.125), lambda: lib_q(b[0]))
        del b, lib_args, lib_q
        p = packed_inputs(torch, gen, R, N, f32)
        rows[f"fused_attention_packed/{label}"] = row(
            p[0].shape, 4 * T * N * C, 4 * T * C * 4,
            lambda: A.fused_attention_packed(*p, HEADS, 0.125),
            lambda: A.fused_attention_plain(*p, HEADS, 0.125), lambda: lib_p(*p))
        del p
    for label, D1, D2 in (("spatial->temporal", F, J), ("temporal->spatial", J, F)):
        a = mlp_inputs(torch, gen, D1, D2, f32)
        T = ROWS * D1 * D2
        pm = (tf32.planes(a[2]), tf32.planes(a[4]))
        lib_args = [a[0], a[1], a[2].t().contiguous(), a[3], a[4].t().contiguous(), *a[5:]]
        flops = 4 * T * C * HIDDEN
        nbytes = 3 * T * C * 4 + 2 * C * HIDDEN * 4 + (HIDDEN + 3 * C) * 4
        rows[f"mlp_block_t/{label}"] = row(
            a[0].shape, flops, nbytes, lambda: M.mlp_block_t(*a, 1e-6, planes=pm),
            lambda: M.mlp_block_t_plain(*a, 1e-6), lambda: lib_m(*lib_args))
        if label == "spatial->temporal":
            ar = [t.view(-1, C) for t in a[:2]] + a[2:]
            lib_r = library_mlp(torch, Fn, transpose=False)
            lib_args = [ar[0], ar[1]] + lib_args[2:]
            rows["mlp_block/rows"] = row(
                ar[0].shape, flops, nbytes, lambda: M.mlp_block(*ar, 1e-6, planes=pm),
                lambda: M.mlp_block_plain(*ar, 1e-6), lambda: lib_r(*lib_args))
            del ar
        del a, lib_args
    # the training path's attention core (K3) and its backward (K4) at the
    # train step's shapes, beside SDPA's fp32 forward and backward; K1-dp
    # (the train-fused stage) there too
    for label, R, N in TRAIN_SHAPES:
        T = R * N
        a = stage_inputs(torch, gen, R, N, f32)
        dp = dp_scales(torch, gen, (R,))
        pa = (tf32.planes(a[1]), tf32.planes(a[3]))
        lib_args = [a[0], a[1].t().contiguous(), a[2], a[3].t().contiguous(), *a[4:]]
        rows[f"attention_stage_dp/{label}"] = row(
            a[0].shape, 2 * T * C * 3 * C + 4 * T * N * C + 2 * T * C * C,
            3 * T * C * 4 + 4 * C * C * 4 + 8 * C * 4 + R * 4,
            lambda: A.attention_stage_dp(*a, dp, HEADS, 0.125, 1e-6, planes=pa),
            lambda: A.attention_stage_dp_plain(*a, dp, HEADS, 0.125, 1e-6),
            lambda: lib_a(*lib_args, dp=dp))
        del a, dp, pa, lib_args
        qkv, dout = qkv_inputs(torch, gen, R, N, f32)
        lib_fwd = library_attention_qkv(torch, Fn, qkv)
        leaf = qkv.clone().requires_grad_(True)
        lib_out = lib_fwd(leaf)
        rows[f"fused_attention_qkv/{label}"] = row(
            qkv.shape, 4 * T * N * C, (3 * C + C) * T * 4,
            lambda: A.fused_attention_qkv(qkv, HEADS, 0.125),
            lambda: A.fused_attention_qkv_plain(qkv, HEADS, 0.125), lambda: lib_fwd(qkv))
        # S recomputed, dV, dP, dQ, dK: five N x N x d products per head
        rows[f"fused_attention_qkv_bwd/{label}"] = row(
            qkv.shape, 10 * T * N * C, (3 * C + C + 3 * C) * T * 4,
            lambda: A.fused_attention_qkv_bwd(qkv, dout, HEADS, 0.125),
            lambda: A.fused_attention_qkv_bwd_plain(qkv, dout, HEADS, 0.125),
            lambda: torch.autograd.grad(lib_out, leaf, dout, retain_graph=True))
        del qkv, dout, leaf, lib_out
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r["flops"], r["bytes"], PEAK_TF32 / 3)
        r["fma_ms"] = 1e3 * r["flops"] / PEAK_FP32_FMA
        log(f"[timing] {name} fp32 x{tuple(r['shape'])}: kernel {r['ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}, three TF32 passes; FMA figure "
            f"{r['fma_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, library (TF32 off) "
            f"{r['library_ms']:.4f} ms, {r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s"
            + launches_text(r))
    return rows


def eval_kernel_rows(torch, Fn, gen):
    """K5 on one block's 165,240 token rows; K6, K7 and K1's attend launch
    alone at the spatial and temporal stage shapes; bf16."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M

    bf = torch.bfloat16
    rows = {}
    a = mlp_inputs(torch, gen, F, J, bf)
    a[:2] = [t.view(-1, C) for t in a[:2]]
    T = a[0].shape[0]
    lib_m = library_mlp(torch, Fn, transpose=False)
    lib_args = [a[0], a[1], a[2].t().contiguous(), a[3].to(bf), a[4].t().contiguous(),
                a[5].to(bf), a[6].to(bf), a[7].to(bf)]
    rows["mlp_block/rows"] = dict(
        shape=list(a[0].shape), flops=4 * T * C * HIDDEN,
        bytes=3 * T * C * 2 + 2 * C * HIDDEN * 2 + (HIDDEN + 3 * C) * 4,
        ms=time_ms(torch, lambda: M.mlp_block(*a, 1e-6), reps=10),
        plain_ms=time_ms(torch, lambda: M.mlp_block_plain(*a, 1e-6), reps=3),
        library_ms=time_ms(torch, lambda: lib_m(*lib_args), reps=10))
    del a, lib_args
    lib_b, lib_p = library_block(torch, Fn), library_packed(torch, Fn)
    for label, R, N in (("spatial", ROWS * F, J), ("temporal", ROWS * J, F)):
        T = R * N
        b = block_inputs(torch, gen, R, N, bf)
        lib_args = [b[0], b[1], b[2].t().contiguous()] + [v.to(bf) for v in b[3:]]
        rows[f"attention_block/{label}"] = dict(
            shape=list(b[0].shape), flops=4 * T * N * C + 2 * T * C * C,
            bytes=6 * T * C * 2 + C * C * 2 + 3 * C * 4,
            ms=time_ms(torch, lambda: A.attention_block(*b, HEADS, 0.125, 1e-6), reps=10),
            plain_ms=time_ms(torch, lambda: A.attention_block_plain(*b, HEADS, 0.125, 1e-6),
                             reps=3),
            library_ms=time_ms(torch, lambda: lib_b(*lib_args), reps=10))
        del lib_args
        # K1's attend launch alone on the stage's packed qkv (ld = 3C); SDPA
        # on its q, k, v views as the yardstick
        lib_q = library_attention_qkv(torch, Fn, b[0])
        rows[f"attend/{label}"] = dict(
            shape=list(b[0].shape), flops=4 * T * N * C, bytes=4 * T * C * 2,
            ms=time_ms(torch, lambda: A.attend_qkv(b[0], HEADS, 0.125), reps=10),
            plain_ms=time_ms(torch, lambda: A.attend_qkv_plain(b[0], HEADS, 0.125), reps=3),
            library_ms=time_ms(torch, lambda: lib_q(b[0]), reps=10))
        del b, lib_q
        p = packed_inputs(torch, gen, R, N, bf)
        rows[f"fused_attention_packed/{label}"] = dict(
            shape=list(p[0].shape), flops=4 * T * N * C, bytes=4 * T * C * 2,
            ms=time_ms(torch, lambda: A.fused_attention_packed(*p, HEADS, 0.125), reps=10),
            plain_ms=time_ms(torch, lambda: A.fused_attention_plain(*p, HEADS, 0.125), reps=3),
            library_ms=time_ms(torch, lambda: lib_p(*p), reps=10))
        del p
    return rows


def train_fused_kernel_rows(torch, Fn, gen):
    """K1-dp, K2-dp and K5-dp at the train step's shapes, where their path
    runs them; K8 at the eval path's stage shapes (its bound is K1's); bf16,
    DropPath scales of 0 and 1/keep."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M

    bf = torch.bfloat16
    rows = {}
    lib_a = library_attention(torch, Fn)
    for label, R, N in STAGE_SHAPES:
        a = stage_inputs(torch, gen, R, N, bf)
        T = R * N
        flops = 2 * T * C * 3 * C + 4 * T * N * C + 2 * T * C * C
        nbytes = 3 * T * C * 2 + 4 * C * C * 2 + 8 * C * 4
        lib_args = [a[0], a[1].t().contiguous(), a[2].to(bf), a[3].t().contiguous(),
                    a[4].to(bf)] + [v.to(bf) for v in a[5:]]
        if label.startswith("train"):
            dp = dp_scales(torch, gen, (R,))
            rows[f"attention_stage_dp/{label.split()[1]}"] = dict(
                shape=list(a[0].shape), flops=flops, bytes=nbytes + R * 4,
                ms=time_ms(torch, lambda: A.attention_stage_dp(*a, dp, HEADS, 0.125, 1e-6),
                           reps=10),
                plain_ms=time_ms(torch, lambda: A.attention_stage_dp_plain(
                    *a, dp, HEADS, 0.125, 1e-6), reps=3),
                library_ms=time_ms(torch, lambda: lib_a(*lib_args, dp=dp.to(bf)), reps=10))
        else:
            hm = [a[0], *A.stack_head_major(a[1], a[2], HEADS), *a[3:]]
            rows[f"attention_stage_hm/{label.split()[1]}"] = dict(
                shape=list(a[0].shape), flops=flops, bytes=nbytes,
                ms=time_ms(torch, lambda: A.attention_stage_hm(*hm, HEADS, 0.125, 1e-6),
                           reps=10),
                plain_ms=time_ms(torch, lambda: A.attention_stage_hm_plain(
                    *hm, HEADS, 0.125, 1e-6), reps=3),
                library_ms=time_ms(torch, lambda: lib_a(*lib_args), reps=10))
        del a, lib_args
    lib_t, lib_r = library_mlp(torch, Fn), library_mlp(torch, Fn, transpose=False)
    for label, n_rows, D1, D2 in MLP_SHAPES[2:]:
        a = mlp_inputs(torch, gen, D1, D2, bf, n_rows)
        T = n_rows * D1 * D2
        flops = 4 * T * C * HIDDEN
        nbytes = 3 * T * C * 2 + 2 * C * HIDDEN * 2 + (HIDDEN + 3 * C) * 4
        lib_args = [a[0], a[1], a[2].t().contiguous(), a[3].to(bf), a[4].t().contiguous(),
                    a[5].to(bf), a[6].to(bf), a[7].to(bf)]
        dp = dp_scales(torch, gen, (n_rows, D1))
        rows[f"mlp_block_t_dp/{label.split()[1]}"] = dict(
            shape=list(a[0].shape), flops=flops, bytes=nbytes + n_rows * D1 * 4,
            ms=time_ms(torch, lambda: M.mlp_block_t_dp(*a, dp, 1e-6), reps=10),
            plain_ms=time_ms(torch, lambda: M.mlp_block_t_dp_plain(*a, dp, 1e-6), reps=3),
            library_ms=time_ms(torch, lambda: lib_t(*lib_args, dp=dp.to(bf)), reps=10))
        if label.endswith("spatial->temporal"):
            r = [t.view(-1, C) for t in a[:2]] + a[2:]
            dpr = dp_scales(torch, gen, (T,))
            lib_rows = [r[0], r[1]] + lib_args[2:]
            rows["mlp_block_dp/rows"] = dict(
                shape=list(r[0].shape), flops=flops, bytes=nbytes + T * 4,
                ms=time_ms(torch, lambda: M.mlp_block_dp(*r, dpr, 1e-6), reps=10),
                plain_ms=time_ms(torch, lambda: M.mlp_block_dp_plain(*r, dpr, 1e-6), reps=3),
                library_ms=time_ms(torch, lambda: lib_r(*lib_rows, dp=dpr.to(bf)), reps=10))
            del r, lib_rows
        del a, lib_args
    return rows


# ------------------------------------------------------------- phase dp
DP_STEPS = 3
DP_B = 4  # the Eval config's windows a micro-batch (DP_B / 2 = 2 a rank: 20 rows)
# bf16 training against one process. The key third of a qkv bias has a
# gradient that is zero in exact arithmetic (softmax ignores a constant
# added to a row's logits), so in bf16 it is rounding noise, which the two
# runs sum in other orders and AdamW normalizes to full-size steps. Such a
# slice is left out of the parameter check where its one-process gradient
# at the first step is zero to rounding: its largest entry under one bf16
# unit (2^-8) of the largest of its query and value thirds (3.0e-6 read on
# an H100). Its gap is reported. The later losses are held at
# BF16_LOSS_TOL relative (1.85e-4 and 1.13e-4 read there).
KEY_BIAS_ZERO = 2.0 ** -8
BF16_LOSS_TOL = 1e-3


def dp_train(torch, mesh, dtype, steps=DP_STEPS, level=None):
    """`steps` train steps at the train config (DropPath 0.1, AdamW 6e-5)
    in `dtype` (at fuse level `level`, default the config's), batches of BT chunks from a seeded ChunkedGenerator through
    the Prefetcher (under a mesh with `shard_batch_fn`, BT / dp chunks a
    rank), weights from seed 0 perturbed by seed 1 (then split over the
    mesh's tp ranks, phase tp). Returns (losses, the whole parameters on the
    host, seconds per step, K3 / K4 launches per step, `key_bias_grads`
    after the first step where the model is not split, the D3DP); the last
    step's launches of every kernel in `dp_train.launches`."""
    from d3dp_tpu_torch.data.generators import ChunkedGenerator
    from d3dp_tpu_torch.data.prefetch import Prefetcher
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT, make_dataset
    from d3dp_tpu_torch.diffusion import D3DP
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.parallel import gather_params, shard_batch_fn, shard_model_params
    from d3dp_tpu_torch.train.state import make_optimizer, make_train_step

    dev = torch.device("cuda") if mesh is None else mesh.device
    cfg = train_config(torch)
    model_cfg = dataclasses.replace(cfg.model, dtype=dtype,
                                    fuse_level=cfg.model.fuse_level if level is None else level)
    d3dp = D3DP(dataclasses.replace(cfg, model=model_cfg), device=dev, seed=0)
    perturb_(torch, d3dp.model, 1)
    shard_model_params(d3dp.model, mesh)
    step = make_train_step(d3dp, make_optimizer(d3dp.model.parameters(), 6e-5), mesh=mesh)
    lr_kw = dict(kps_left=list(JOINTS_LEFT), kps_right=list(JOINTS_RIGHT),
                 joints_left=list(JOINTS_LEFT), joints_right=list(JOINTS_RIGHT))
    gen = ChunkedGenerator(BT, *make_dataset(seed=5, lengths=(1200, 900)), F, shuffle=True,
                           random_seed=1234, augment=True, pad_last=True, **lr_kw)
    batches = iter(Prefetcher(gen.next_epoch(), depth=2,
                              to_device=None if mesh is None else shard_batch_fn(mesh)))
    g = torch.Generator(device=dev).manual_seed(11)
    losses, seconds, counts, key_grads = [], [], [], None
    for _ in range(steps):
        _, b3, b2, w = next(batches)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(b2, b3, w, generator=g).item())
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts.append((A.fused_attention_qkv.launches, A.fused_attention_qkv_bwd.launches))
        dp_train.launches = {n: c for n, c in read_counts().items() if c}
        if d3dp.model.tp is None:
            key_grads = key_grads or key_bias_grads(torch, d3dp.model)
    batches.close()
    params = {n: p.float().cpu() for n, p in gather_params(d3dp.model).items()}
    return losses, params, seconds, counts, key_grads, d3dp


def key_bias_grads(torch, model):
    """{name: (max|g| of the key third, max|g| of the query and value
    thirds)} of every qkv bias's gradient."""
    out = {}
    for n, p in model.named_parameters():
        if n.endswith("attn.qkv.bias"):
            g = p.grad.float().abs()
            out[n] = (g[C:2 * C].max().item(), torch.cat([g[:C], g[2 * C:]]).max().item())
    return out


def param_gaps(torch, params, want, left_out=()):
    """(max over tensors of the relative L2 distance, max over tensors of
    max|diff| / max|p|) of `params` from `want`, with the key third of
    each qkv bias named in `left_out` removed."""
    def kept(n, p):
        return torch.cat([p[:C], p[2 * C:]]) if n in left_out else p

    pairs = [(kept(n, params[n]), kept(n, p)) for n, p in want.items()]
    return (max(((a - b).norm() / b.norm()).item() for a, b in pairs),
            max((a - b).abs().max().item() / b.abs().max().item() for a, b in pairs))


def dp_eval(torch, mesh):
    """One Eval-config micro-batch (DP_B windows of a 972-frame synthetic
    sequence, H=5, K=5, flip-TTA, bf16) through the Evaluator at fuse
    levels 4 and 5, each after an untimed warm-up call, on one noise seed.
    Returns {level: (P1 mode -> (K,) list, seconds, launches)}."""
    from d3dp_tpu_torch.data.generators import UnchunkedGenerator
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT, make_dataset
    from d3dp_tpu_torch.diffusion import D3DP
    from d3dp_tpu_torch.eval import MODES, Evaluator

    dev = torch.device("cuda") if mesh is None else mesh.device
    d3dp = D3DP(main_config(torch), device=dev, seed=0)
    perturb_(torch, d3dp.model, 1)
    data = make_dataset(seed=3, lengths=(DP_B * F,))
    ev = Evaluator(d3dp, receptive_field=F, batch_size=DP_B, mesh=mesh,
                   kps_left=list(JOINTS_LEFT), kps_right=list(JOINTS_RIGHT))
    out = {}
    for level in (4, 5):
        set_level(d3dp.model, level)
        for timed in (False, True):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ev.evaluate(UnchunkedGenerator(*data),
                              torch.Generator(device=dev).manual_seed(21)).averages_mm()
            torch.cuda.synchronize()
        out[level] = ({m: res[m].tolist() for m in MODES}, time.perf_counter() - t0,
                      read_counts())
    return out


def dp_train_rep(torch, mesh, ref, steps=DP_STEPS):
    """dp_train in fp32 and bf16 on `mesh`, against the one-process `ref`:
    each step's loss relative to it, and the parameters' `param_gaps` from
    it; in bf16 without the key-bias slices whose reference gradient is
    zero to rounding (KEY_BIAS_ZERO), whose own gaps are reported."""
    rep = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        losses, params, step_s, counts, _, d3dp = dp_train(torch, mesh, dt, steps)
        want = ref[name]
        ratios = {n: k / qv for n, (k, qv) in want["key_grads"].items()}
        left_out = sorted(n for n, r in ratios.items() if r <= KEY_BIAS_ZERO) \
            if dt == torch.bfloat16 else []
        rel_l2, rel_max = param_gaps(torch, params, want["params"], left_out)
        key = [(params[n][C:2 * C], want["params"][n][C:2 * C]) for n in left_out]
        rep[name] = dict(
            losses=losses, step_s=step_s, step_counts=counts,
            loss_rel=[abs(a - b) / abs(b) for a, b in zip(losses, want["losses"])],
            param_rel_l2=rel_l2, param_rel_max=rel_max,
            param_rel_l2_all=param_gaps(torch, params, want["params"])[0],
            key_ratio_max=max(ratios.values()), left_out=len(left_out),
            key_rel_l2=max((((a - b).norm() / b.norm()).item() for a, b in key), default=0.0),
            key_max_diff=max(((a - b).abs().max().item() for a, b in key), default=0.0),
            finite=all(bool(torch.isfinite(p).all()) for p in params.values()),
            launches=dp_train.launches)
    return rep, d3dp


def dp_rank(out_dir, devices):
    """One rank of phase dp (a spawned process): dp_train (fp32 and bf16)
    and dp_eval on a mesh over `devices`, each rank's numbers against the
    one-process reference in out_dir/ref.pt, the gradient all-reduce and a
    micro-batch's error all-reduce timed; the report to
    out_dir/rank<r>.json."""
    import torch
    import torch.distributed as dist

    from d3dp_tpu_torch import disable_tf32
    from d3dp_tpu_torch.parallel import make_mesh

    disable_tf32()
    mesh = make_mesh(dp=2, devices=devices)
    ref = torch.load(os.path.join(out_dir, "ref.pt"), weights_only=False)
    train, d3dp = dp_train_rep(torch, mesh, ref["train"])
    model_params = list(d3dp.model.parameters())

    def timed(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps

    # the gradients' all-reduce alone, as one flat fp32 tensor (the step's
    # DistributedDataParallel reduces them in buckets while its backward runs)
    n_grad = sum(p.numel() for p in model_params)
    flat = torch.zeros(n_grad, device=mesh.device)
    grad_s = timed(lambda: dist.all_reduce(flat))
    del d3dp, model_params, flat
    small = torch.zeros(4 * K + K * H, device=mesh.device)
    err_s = timed(lambda: dist.all_reduce(small))
    ev = dp_eval(torch, mesh)
    rep = dict(rank=mesh.rank, device=str(mesh.device), train=train, grad_allreduce_s=grad_s,
               grad_floats=n_grad, error_allreduce_s=err_s,
               eval={str(k): v for k, v in ev.items()},
               eval_vs_ref=max(abs(a - b) for m, v in ev[4][0].items()
                               for a, b in zip(v, ref["eval"][4][0][m])),
               level5_equal=ev[5][0] == ev[4][0])
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(rep, f)


def check_dp_ranks(torch, out_dir, label, record):
    """Read and check the two ranks' reports of one multi-rank part.
    Training is held at loss 1e-5 and parameters 1e-3 relative (L2); in
    bf16 the losses after the first step (the same parameters on both
    sides) at BF16_LOSS_TOL, and the parameters without the key-bias
    slices that KEY_BIAS_ZERO leaves out (their gaps reported)."""
    per_step = 2 * DEPTH
    reps = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            rep = json.load(f)
        reps.append(rep)
        e4, e5 = rep["eval"]["4"], rep["eval"]["5"]
        counts4 = (e4[2]["attention_stage"], e4[2]["mlp_block_t"])
        counts5 = e5[2]["resident_block_stack"]
        t32, t16 = rep["train"]["float32"], rep["train"]["bfloat16"]
        ok_counts = (all(tuple(c) == (per_step, per_step)
                         for t in (t32, t16) for c in t["step_counts"])
                     and counts4 == (2 * DEPTH * K,) * 2 and counts5 == K)
        ok_train = (max(t32["loss_rel"]) <= 1e-5 and t32["param_rel_l2"] <= 1e-3
                    and t16["loss_rel"][0] <= 1e-5 and max(t16["loss_rel"]) <= BF16_LOSS_TOL
                    and t16["param_rel_l2"] <= 1e-3 and t32["finite"] and t16["finite"]
                    and all(math.isfinite(v) for v in t16["losses"]))
        ok = ok_train and rep["eval_vs_ref"] <= 3.1e-4 and rep["level5_equal"] and ok_counts
        for name, t in (("fp32", t32), ("bf16", t16)):
            log(f"[dp] {label} rank {r} on {rep['device']}: {name} train losses "
                f"{' '.join(f'{v:.6f}' for v in t['losses'])}; against one process: losses "
                f"{' '.join(f'{v:.2e}' for v in t['loss_rel'])} relative, parameters relative L2 "
                f"{t['param_rel_l2']:.3e} (max|diff| / max|p| {t['param_rel_max']:.3e}); "
                f"s/step {' '.join(f'{v:.4f}' for v in t['step_s'])}")
        log(f"[dp] {label} rank {r}: bf16 key-bias slices left out {t16['left_out']} of "
            f"{2 * DEPTH} (largest reference key/query-value gradient ratio "
            f"{t16['key_ratio_max']:.3e}, rule <= {KEY_BIAS_ZERO:g}; fp32 "
            f"{t32['key_ratio_max']:.3e}): their gap relative L2 {t16['key_rel_l2']:.3e}, "
            f"max|diff| {t16['key_max_diff']:.3e}; every bf16 parameter relative L2 "
            f"{t16['param_rel_l2_all']:.3e}")
        log(f"[dp] {label} rank {r}: tolerances loss 1e-5, parameters 1e-3, bf16 later "
            f"losses {BF16_LOSS_TOL:g}; evaluator level 4 four modes max|diff| "
            f"{rep['eval_vs_ref']:.3e} mm "
            f"(tol 3.1e-4), level 5 equal to level 4 {rep['level5_equal']}; launches a step "
            f"K3/K4 {t16['step_counts']}, level 4 K1/K2 {counts4}, level 5 K9 {counts5} "
            f"{'ok' if ok else 'FAIL'}")
        log(f"[dp] {label} rank {r}: s/micro-batch level 4 {e4[1]:.4f} level 5 {e5[1]:.4f}; "
            f"gradient all-reduce ({rep['grad_floats']} fp32) {rep['grad_allreduce_s'] * 1e3:.2f} "
            f"ms, error all-reduce {rep['error_allreduce_s'] * 1e3:.3f} ms")
        check(ok, f"phase dp {label}: rank {r} disagrees with one process or miscounts launches")
    same = all(reps[0]["train"][n]["losses"] == reps[1]["train"][n]["losses"]
               for n in ("float32", "bfloat16"))
    same = same and all(reps[0]["eval"][lv][0] == reps[1]["eval"][lv][0] for lv in ("4", "5"))
    check(same, f"phase dp {label}: the ranks' losses or metrics differ")
    log("[dp] " + json.dumps({"dp_launches": [
        {"part": label, "rank": rep["rank"],
         "fused_attention_qkv": rep["train"]["bfloat16"]["step_counts"][0][0],
         "fused_attention_qkv_bwd": rep["train"]["bfloat16"]["step_counts"][0][1],
         "attention_stage": rep["eval"]["4"][2]["attention_stage"],
         "mlp_block_t": rep["eval"]["4"][2]["mlp_block_t"],
         "resident_block_stack": rep["eval"]["5"][2]["resident_block_stack"]}
        for rep in reps]}))
    record.setdefault("dp", {})[label] = reps


def check_dp_rows(torch, errs):
    """K1, K2 and K9 (the level-4 chain at depth 2, and its plain version
    at depth 1) at the 20 hypothesis rows that a rank of phase dp samples,
    bf16."""
    from d3dp_tpu_torch.ops import resident as R

    gen = torch.Generator(device="cuda").manual_seed(40)
    check_3dhp_rows(torch, gen, torch.bfloat16, "bfloat16", errs, rows=DP_B * H, tag="dp rank")
    x, tpos, sp, tp, shared = resident_inputs(torch, torch.bfloat16, 61, rows=DP_B * H)
    args = (x, tpos, tuple(w[:1] for w in sp), tuple(w[:1] for w in tp), shared)
    got = R.resident_block_stack(*args, HEADS, 0.125, 1e-6)
    want = R.resident_block_stack_plain(*args, HEADS, 0.125, 1e-6)
    torch.cuda.synchronize()
    e, ex = max_err(torch, got, want, BF16_ULP)
    log(f"[dp] resident_block_stack bfloat16 x{tuple(x.shape)} depth 1 against its plain "
        f"version: max|err| {e:.3e} (tol {TOL['bfloat16']:g} + 1 bf16 ulp) "
        f"{'ok' if ex <= TOL['bfloat16'] else 'FAIL'}")
    check(ex <= TOL["bfloat16"], "resident_block_stack at a rank's 20 rows disagrees with its "
                                 "plain version")
    errs["resident_block_stack"] = max(errs["resident_block_stack"], e)
    del x, args, got, want


def phase_dp(torch, record, errs):
    """Data-parallel training and evaluation (`parallel/`) at the published
    width, against one process on the same batches, weights and noise:
      (a) two ranks sharing the one card over gloo
          (`make_mesh(devices=["cuda:0", "cuda:0"])`): DP_STEPS train steps
          at BT chunks (2 a rank) and one Eval-config micro-batch (2
          windows, 20 hypothesis rows a rank) at levels 4 and 5; loss 1e-5
          relative, parameters 1e-3 relative L2, the four modes 3.1e-4 mm,
          level 5 equal to level 4, exact launch counts a rank; K1, K2 and
          K9 against their plain versions at 20 rows;
      (b) a world of one over NCCL: the same code, equal to the run
          without a mesh;
      (c) NCCL at world size 2 over two cards, where the box has them
          (else a line says it was not run).
    Per rank: seconds per step and per micro-batch, the all-reduces' times."""
    import socket

    import torch.distributed as dist

    from d3dp_tpu_torch.parallel import make_mesh, spawn

    t_phase = time.perf_counter()
    check_dp_rows(torch, errs)

    # the one-process reference
    ref = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        losses, params, step_s, _, key_grads, d3dp = dp_train(torch, None, dt)
        ref[name] = dict(losses=losses, params=params, key_grads=key_grads)
        log(f"[dp] one process {name}: train losses {' '.join(f'{v:.6f}' for v in losses)}, "
            f"s/step {' '.join(f'{v:.4f}' for v in step_s)}")
        del d3dp
    ev = dp_eval(torch, None)
    out_dir = os.path.join(os.getcwd(), "log", "chip_smoke_dp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.save(dict(train=ref, eval=ev), os.path.join(out_dir, "ref.pt"))
    log(f"[dp] one process: s/micro-batch ({DP_B} windows) level 4 {ev[4][1]:.4f} level 5 "
        f"{ev[5][1]:.4f}")
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    spawn(dp_rank, 2, out_dir, ["cuda:0", "cuda:0"], backend="gloo")
    log(f"[dp] (a) two ranks on one card over gloo: {time.perf_counter() - t0:.1f} s with the "
        "processes' start")
    check_dp_ranks(torch, out_dir, "gloo, 2 ranks on cuda:0", record)

    # (b) a world of one over NCCL: the mesh code path, equal to no mesh
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        mesh = make_mesh(dp=1, devices=["cuda:0"])
        l1, p1, _, c1, _, d3dp = dp_train(torch, mesh, torch.bfloat16)
        del d3dp
        ev1 = dp_eval(torch, mesh)
    finally:
        dist.destroy_process_group()
    want = ref["bfloat16"]
    same_l = l1 == want["losses"]
    same_p = all(torch.equal(p1[n], p) for n, p in want["params"].items())
    ok = same_l and same_p and ev1[4][0] == ev[4][0] and ev1[5][0] == ev[5][0]
    log(f"[dp] (b) a world of one over NCCL, bf16: losses equal {same_l}, parameters equal "
        f"{same_p}, evaluator levels 4 and 5 equal {ev1[4][0] == ev[4][0]} "
        f"{ev1[5][0] == ev[5][0]}; launches a step {c1} {'ok' if ok else 'FAIL'}")
    check(ok, "phase dp (b): the world-of-one mesh run differs from the run without a mesh")

    if torch.cuda.device_count() >= 2:
        spawn(dp_rank, 2, out_dir, ["cuda:0", "cuda:1"], backend="nccl")
        check_dp_ranks(torch, out_dir, "nccl, 2 ranks on cuda:0 and cuda:1", record)
    else:
        log(f"[dp] (c) NCCL at world size 2: not run, the box has "
            f"{torch.cuda.device_count()} card")
    shutil.rmtree(out_dir, ignore_errors=True)
    record.setdefault("dp", {})["seconds"] = time.perf_counter() - t_phase
    log(f"[dp] phase dp: {record['dp']['seconds']:.1f} s")


# ------------------------------------------------------------- phase tp
TP = 2  # the tensor-parallel ranks of the multi-rank parts
# the Eval-config micro-batch cut to one window (10 hypothesis rows): every
# call all-reduces about 165 fp32 activations of 85 MB through the host
TP_WINDOWS = 1
TP_ROWS = 2 * TP_WINDOWS * H
TP_EDGES = ((1, 17), (7, 9), (127, 1), (3, 43))  # (R, N): token rows around the 64-row tiles
TP_MLP_EDGES = ((1, 63, 1), (1, 65, 1), (1, 129, 1), (3, 7, 5))  # (rows, D1, D2)


def tp_index(torch, n, tp, j, parts=1):
    """Rank j's entries of an axis of n = parts * X: its X / tp slice of
    each part (qkv's q, k and v: a head-aligned share of each)."""
    x, per = n // parts, n // parts // tp
    return torch.cat([torch.arange(p * x + j * per, p * x + (j + 1) * per)
                      for p in range(parts)]).cuda()


def tp_stage_args(torch, a, tp, j):
    """Rank j's K1-tp operands (x, wqkv, bqkv, ln1_s, ln1_b, wp) from the
    whole K1's (`stage_inputs`' order)."""
    idx, cl = tp_index(torch, 3 * C, tp, j, 3), C // tp
    return (a[0], a[1][:, idx].contiguous(), a[2][idx].contiguous(), a[5], a[6],
            a[3][j * cl:(j + 1) * cl].contiguous())


def tp_block_args(torch, b, tp, j):
    """Rank j's K6-tp operands (qkv, wp) from the whole K6's."""
    cl = C // tp
    return (b[0][..., tp_index(torch, 3 * C, tp, j, 3)].contiguous(),
            b[2][j * cl:(j + 1) * cl].contiguous())


def tp_mlp_args(torch, a, tp, j):
    """Rank j's K2/K5-tp operands (x rows, w1, b1, w2) from the whole K2's."""
    hl = HIDDEN // tp
    return (a[0].reshape(-1, C), a[2][:, j * hl:(j + 1) * hl].contiguous(),
            a[3][j * hl:(j + 1) * hl].contiguous(), a[4][j * hl:(j + 1) * hl].contiguous())


def check_tp_kernels(torch, errs):
    """Phase tp (i): K1-tp, K8-tp (the head-major partial stage), K6-tp,
    K2/K5-tp and residual_ln against their plain versions, at tp 2, 4 and 8
    (4, 2 and 1 heads a rank; 512, 256 and 128 hidden units; tp 8 at the
    train step's shapes in place of the eval path's), at the eval path's 40
    rows and at token-row counts around the tiles, fp32 and bf16; the
    ranks' partials summed and finished by residual_ln against the whole
    K1, K8, K6, K2 (transposed) and K5 (rows); then residual_ln with its
    DropPath scale (`dp`) at the train step's shapes, in its three layouts,
    against its plain version and, after the K1-tp and K2/K5-tp partials,
    against K1-dp, K2-dp and K5-dp; all at the same bounds: fp32 1e-4,
    bf16 3e-2 + 1 bf16 ulp. K8-tp's partial is also compared with K1-tp's
    bit for bit (the two load the same weight columns to the same places)."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M
    from d3dp_tpu_torch.ops import residual_ln as RL

    gen = torch.Generator(device="cuda").manual_seed(70)
    scale = (C // HEADS) ** -0.5
    for dt, name_dt in ((torch.float32, "float32"), (torch.bfloat16, "bfloat16")):
        ulp = BF16_ULP if dt == torch.bfloat16 else 0.0
        tol = TOL[name_dt]

        def held(name, label, got, want):
            es = [max_err(torch, g, w, ulp) for g, w in zip(got, want)]
            ok = all(ex <= tol for _, ex in es)
            log(f"[tp] {name} {label} {name_dt}: max|err| "
                f"{' / '.join(f'{e:.3e}' for e, _ in es)} (tol {tol:g}"
                f"{' + 1 bf16 ulp' if ulp else ''}) {'ok' if ok else 'FAIL'}")
            check(ok, f"{name} {label} {name_dt} disagrees")
            if dt == torch.bfloat16:
                errs[name] = max(errs.get(name, 0.0), *(e for e, _ in es))

        for tp in (2, 4, 8):
            heads = HEADS // tp
            shapes = (TRAIN_SHAPES if tp == 8 else (
                ("spatial", ROWS * F, J), ("temporal", ROWS * J, F))) + tuple(
                (f"edge ({r}, {n})", r, n) for r, n in TP_EDGES)
            for label, R, N in shapes:
                tag = f"tp {tp} {label} x({R}, {N}, {C})"
                a = stage_inputs(torch, gen, R, N, dt)
                parts = []
                for j in range(tp):
                    sa = tp_stage_args(torch, a, tp, j)
                    parts.append(A.attention_stage_partial(*sa, heads, scale, 1e-6))
                    held("attention_stage_partial", f"{tag} rank {j}", parts[-1:],
                         (A.attention_stage_partial_plain(*sa, heads, scale, 1e-6),))
                total = sum(parts[1:], parts[0])
                got = RL.residual_ln(a[0], total, a[4], a[7], a[8], 1e-6)
                held("residual_ln", f"{tag} attention half", got,
                     RL.residual_ln_plain(a[0], total, a[4], a[7], a[8], 1e-6))
                held("attention_stage_partial", f"{tag} sum + residual_ln against K1", got,
                     A.attention_stage(*a, HEADS, scale, 1e-6))
                hm_parts, same = [], True
                for j in range(tp):
                    sa = tp_stage_args(torch, a, tp, j)
                    hm = (sa[0], *A.stack_head_major(sa[1], sa[2], heads), *sa[3:])
                    hm_parts.append(A.attention_stage_hm_partial(*hm, heads, scale, 1e-6))
                    held("attention_stage_hm_partial", f"{tag} rank {j}", hm_parts[-1:],
                         (A.attention_stage_hm_partial_plain(*hm, heads, scale, 1e-6),))
                    same = same and torch.equal(hm_parts[-1], parts[j])
                got = RL.residual_ln(a[0], sum(hm_parts[1:], hm_parts[0]), a[4], a[7], a[8], 1e-6)
                held("attention_stage_hm_partial", f"{tag} sum + residual_ln against K8", got,
                     A.attention_stage_hm(a[0], *A.stack_head_major(a[1], a[2], HEADS), *a[3:],
                                          HEADS, scale, 1e-6))
                log(f"[tp] attention_stage_hm_partial {tag} {name_dt}: equal to K1-tp's partial "
                    f"bit for bit {same}")
                del hm_parts
                b = block_inputs(torch, gen, R, N, dt)
                parts = []
                for j in range(tp):
                    qkv_j, wp_j = tp_block_args(torch, b, tp, j)
                    parts.append(A.attention_block_partial(qkv_j, wp_j, heads, scale))
                    held("attention_block_partial", f"{tag} rank {j}", parts[-1:],
                         (A.attention_block_partial_plain(qkv_j, wp_j, heads, scale),))
                total = sum(parts[1:], parts[0])
                held("attention_block_partial", f"{tag} sum + residual_ln against K6",
                     RL.residual_ln(b[1], total, b[3], b[4], b[5], 1e-6),
                     A.attention_block(*b, HEADS, scale, 1e-6))
                del a, b, parts, total, got
            n_rows = BT if tp == 8 else ROWS
            mlp_shapes = (("spatial->temporal", n_rows, F, J),
                          ("temporal->spatial", n_rows, J, F)) \
                + tuple((f"edge {(r, d1, d2)}", r, d1, d2) for r, d1, d2 in TP_MLP_EDGES)
            for label, rows, D1, D2 in mlp_shapes:
                tag = f"tp {tp} {label} x({rows}, {D1}, {D2}, {C})"
                a = mlp_inputs(torch, gen, D1, D2, dt, rows=rows)
                parts = []
                for j in range(tp):
                    ma = tp_mlp_args(torch, a, tp, j)
                    parts.append(M.mlp_block_partial(*ma))
                    held("mlp_block_partial", f"{tag} rank {j}", parts[-1:],
                         (M.mlp_block_partial_plain(*ma),))
                total = sum(parts[1:], parts[0]).view(a[1].shape)
                got = RL.residual_ln(a[1], total, *a[5:], 1e-6, with_x2=False, transpose=True)
                held("residual_ln", f"{tag} MLP half, transposed", (got,),
                     (RL.residual_ln_plain(a[1], total, *a[5:], 1e-6, with_x2=False,
                                           transpose=True),))
                held("mlp_block_partial", f"{tag} sum + residual_ln against K2", (got,),
                     (M.mlp_block_t(*a, 1e-6),))
                rows_args = [t.reshape(-1, C) for t in a[:2]] + a[2:]
                held("mlp_block_partial", f"{tag} sum + residual_ln against K5",
                     (RL.residual_ln(rows_args[1], total.view(-1, C), *a[5:], 1e-6,
                                     with_x2=False),),
                     (M.mlp_block(*rows_args, 1e-6),))
                del a, parts, total, got, rows_args
            check_residual_ln_dp(torch, gen, held, scale, dt, tp)
    torch.cuda.synchronize()


def check_residual_ln_dp(torch, gen, held, scale, dt, tp):
    """residual_ln's DropPath form (`dp`) in dt at the train step's shapes
    and at token-row counts around its 8-row blocks, after the `tp` ranks'
    K1-tp and K2/K5-tp partials: against its plain version and against
    K1-dp (dp (R,), one a sequence), K2-dp (transposed) and K5-dp (rows; dp
    (rows, D1), one a (b, i), repeated over its D2 rows for K5-dp's one a
    row); `held` holds each at phase tp's bounds."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M
    from d3dp_tpu_torch.ops import residual_ln as RL

    heads = HEADS // tp
    for label, R, N in TRAIN_SHAPES + tuple((f"edge ({r}, {n})", r, n) for r, n in TP_EDGES):
        tag = f"tp {tp} train {label} x({R}, {N}, {C}) dp ({R},)"
        a = stage_inputs(torch, gen, R, N, dt)
        dp = dp_scales(torch, gen, (R,))
        total = sum(A.attention_stage_partial(*tp_stage_args(torch, a, tp, j), heads, scale, 1e-6)
                    for j in range(tp))
        got = RL.residual_ln(a[0], total, a[4], a[7], a[8], 1e-6, dp=dp)
        held("residual_ln[dp]", f"{tag} attention half", got,
             RL.residual_ln_plain(a[0], total, a[4], a[7], a[8], 1e-6, dp=dp))
        held("residual_ln[dp]", f"{tag} sum + residual_ln against K1-dp", got,
             A.attention_stage_dp(*a, dp, HEADS, scale, 1e-6))
    for label, rows, D1, D2 in (("spatial->temporal", BT, F, J), ("temporal->spatial", BT, J, F)) \
            + tuple((f"edge {(r, d1, d2)}", r, d1, d2) for r, d1, d2 in TP_MLP_EDGES):
        tag = f"tp {tp} train {label} x({rows}, {D1}, {D2}, {C}) dp ({rows}, {D1})"
        a = mlp_inputs(torch, gen, D1, D2, dt, rows=rows)
        dp = dp_scales(torch, gen, (rows, D1))
        total = sum(M.mlp_block_partial(*tp_mlp_args(torch, a, tp, j))
                    for j in range(tp)).view(a[1].shape)
        rows = [t.reshape(-1, C) for t in a[:2]] + a[2:]
        for transpose, what, ref, want in (
                (True, "MLP half, transposed", "K2-dp", M.mlp_block_t_dp(*a, dp, 1e-6)),
                (False, "MLP half, rows", "K5-dp", M.mlp_block_dp(
                    *rows, dp.repeat_interleave(D2, dim=1).reshape(-1), 1e-6).view(a[1].shape))):
            got = RL.residual_ln(a[1], total, *a[5:], 1e-6, with_x2=False, transpose=transpose,
                                 dp=dp)
            held("residual_ln[dp]", f"{tag} {what}", (got,),
                 (RL.residual_ln_plain(a[1], total, *a[5:], 1e-6, with_x2=False,
                                       transpose=transpose, dp=dp),))
            held("residual_ln[dp]", f"{tag} sum + residual_ln against {ref}", (got,), (want,))


def library_stage_partial(torch, Fn, heads):
    """layer_norm, F.linear, SDPA on the rank's heads, F.linear without a
    bias in fp32 out (the yardstick of K1-tp)."""
    def run(x, wqkv_t, bqkv, wp_t, l1s, l1b):
        R, N, _ = x.shape
        y1 = Fn.layer_norm(x, (C,), l1s, l1b, 1e-6)
        q, k, v = Fn.linear(y1, wqkv_t, bqkv).view(R, N, 3, heads, 64).permute(
            2, 0, 3, 1, 4).unbind(0)
        o = Fn.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(R, N, heads * 64)
        return Fn.linear(o, wp_t).float()
    return run


def tp_kernel_rows(torch, Fn, rows=TP_ROWS, tp=TP):
    """Phase tp (iv): each new form timed (bf16, CUDA events) at a rank's
    shapes on phase tp's path (`rows` hypothesis rows, `tp` ranks; K8-tp
    with the K1-tp row's work and library sequence; residual_ln's DropPath
    form at the train step's shapes, where the train-fused tp step runs
    it), beside the whole kernel at the same rows, its plain version, one
    library sequence for the same work and its bound."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M
    from d3dp_tpu_torch.ops import residual_ln as RL

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(71)
    heads, cl, hl = HEADS // tp, C // tp, HIDDEN // tp
    scale = (C // HEADS) ** -0.5
    out = {}
    for label, R, N in (("spatial", rows * F, J), ("temporal", rows * J, F)):
        T = R * N
        a = stage_inputs(torch, gen, R, N, bf)
        sa = tp_stage_args(torch, a, tp, 0)
        lib = library_stage_partial(torch, Fn, heads)
        lib_args = (sa[0], sa[1].t().contiguous(), sa[2].to(bf), sa[5].t().contiguous(),
                    sa[3].to(bf), sa[4].to(bf))
        out[f"attention_stage_partial/{label}"] = dict(
            shape=list(a[0].shape), tp=tp,
            flops=2 * T * C * 3 * cl + 4 * T * N * cl + 2 * T * cl * C,
            bytes=T * C * 2 + (3 * C * cl + cl * C) * 2 + (3 * cl + 2 * C) * 4 + T * C * 4,
            ms=time_ms(torch, lambda: A.attention_stage_partial(*sa, heads, scale, 1e-6),
                       reps=10),
            whole_ms=time_ms(torch, lambda: A.attention_stage(*a, HEADS, scale, 1e-6), reps=10),
            plain_ms=time_ms(torch, lambda: A.attention_stage_partial_plain(
                *sa, heads, scale, 1e-6), reps=3),
            library_ms=time_ms(torch, lambda: lib(*lib_args), reps=10))
        part = A.attention_stage_partial(*sa, heads, scale, 1e-6)
        rl = (a[0], part, a[4], a[7], a[8], 1e-6)
        out[f"residual_ln/{label} attention half"] = dict(
            shape=list(a[0].shape), tp=tp, flops=10 * T * C,
            bytes=T * C * (2 + 4 + 2 + 2) + 3 * C * 4,
            ms=time_ms(torch, lambda: RL.residual_ln(*rl), reps=10),
            plain_ms=time_ms(torch, lambda: RL.residual_ln_plain(*rl), reps=3),
            library_ms=time_ms(torch, lambda: Fn.layer_norm(
                a[0].float() + (part + a[4]), (C,), a[7], a[8], 1e-6), reps=10))
        b = block_inputs(torch, gen, R, N, bf)
        qkv_j, wp_j = tp_block_args(torch, b, tp, 0)
        wp_t = wp_j.t().contiguous()

        def lib_block():
            q, k, v = qkv_j.view(R, N, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)
            o = Fn.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(R, N, cl)
            return Fn.linear(o, wp_t).float()
        out[f"attention_block_partial/{label}"] = dict(
            shape=list(qkv_j.shape), tp=tp, flops=4 * T * N * cl + 2 * T * cl * C,
            bytes=T * 3 * cl * 2 + cl * C * 2 + T * C * 4,
            ms=time_ms(torch, lambda: A.attention_block_partial(qkv_j, wp_j, heads, scale),
                       reps=10),
            whole_ms=time_ms(torch, lambda: A.attention_block(*b, HEADS, scale, 1e-6), reps=10),
            plain_ms=time_ms(torch, lambda: A.attention_block_partial_plain(
                qkv_j, wp_j, heads, scale), reps=3),
            library_ms=time_ms(torch, lib_block, reps=10))
        hm = (sa[0], *A.stack_head_major(sa[1], sa[2], heads), *sa[3:])
        whole_hm = (a[0], *A.stack_head_major(a[1], a[2], HEADS), *a[3:])
        out[f"attention_stage_hm_partial/{label}"] = dict(
            out[f"attention_stage_partial/{label}"],
            ms=time_ms(torch, lambda: A.attention_stage_hm_partial(*hm, heads, scale, 1e-6),
                       reps=10),
            whole_ms=time_ms(torch, lambda: A.attention_stage_hm(*whole_hm, HEADS, scale, 1e-6),
                             reps=10),
            plain_ms=time_ms(torch, lambda: A.attention_stage_hm_partial_plain(
                *hm, heads, scale, 1e-6), reps=3))
        del a, sa, lib_args, part, rl, b, qkv_j, wp_j, wp_t, hm, whole_hm
    # the DropPath form of residual_ln at the train step's shapes (the
    # D3DP_TRAIN_FUSED=1 step under tp runs it; every row on every rank)
    for label, R, N in TRAIN_SHAPES:
        T = R * N
        a = stage_inputs(torch, gen, R, N, bf)
        part = torch.randn(R, N, C, generator=gen, device="cuda")
        dp = dp_scales(torch, gen, (R,))
        rl = (a[0], part, a[4], a[7], a[8], 1e-6)
        out[f"residual_ln[dp]/train {label} attention half"] = dict(
            shape=list(a[0].shape), tp=tp, flops=11 * T * C,
            bytes=T * C * (2 + 4 + 2 + 2) + 3 * C * 4 + R * 4,
            ms=time_ms(torch, lambda: RL.residual_ln(*rl, dp=dp), reps=10),
            plain_ms=time_ms(torch, lambda: RL.residual_ln_plain(*rl, dp=dp), reps=3),
            library_ms=time_ms(torch, lambda: Fn.layer_norm(
                a[0].float() + dp[:, None, None] * (part + a[4]), (C,), a[7], a[8], 1e-6),
                reps=10))
        del a, part, dp, rl
    for label, D1, D2 in (("spatial->temporal", F, J), ("temporal->spatial", J, F)):
        a = mlp_inputs(torch, gen, D1, D2, bf, rows=BT)
        part = torch.randn(a[1].shape, generator=gen, device="cuda")
        dp = dp_scales(torch, gen, (BT, D1))
        T = BT * D1 * D2
        rl = (a[1], part, *a[5:], 1e-6)
        out[f"residual_ln[dp]/train {label} MLP half"] = dict(
            shape=list(a[1].shape), tp=tp, flops=11 * T * C,
            bytes=T * C * (2 + 4 + 2) + 3 * C * 4 + BT * D1 * 4,
            ms=time_ms(torch, lambda: RL.residual_ln(*rl, with_x2=False, transpose=True, dp=dp),
                       reps=10),
            plain_ms=time_ms(torch, lambda: RL.residual_ln_plain(
                *rl, with_x2=False, transpose=True, dp=dp), reps=3),
            library_ms=time_ms(torch, lambda: Fn.layer_norm(
                a[1].float() + dp[:, :, None, None] * (part + a[5]), (C,), a[6], a[7],
                1e-6).transpose(1, 2).contiguous(), reps=10))
        del a, part, dp, rl
    for label, D1, D2 in (("spatial->temporal", F, J), ("temporal->spatial", J, F)):
        T = rows * D1 * D2
        a = mlp_inputs(torch, gen, D1, D2, bf, rows=rows)
        ma = tp_mlp_args(torch, a, tp, 0)
        lib_w = (ma[1].t().contiguous(), ma[2].to(bf), ma[3].t().contiguous())
        out[f"mlp_block_partial/{label}"] = dict(
            shape=list(ma[0].shape), tp=tp, flops=4 * T * C * hl,
            bytes=T * C * 2 + 2 * C * hl * 2 + hl * 4 + T * C * 4,
            ms=time_ms(torch, lambda: M.mlp_block_partial(*ma), reps=10),
            whole_ms=time_ms(torch, lambda: M.mlp_block_t(*a, 1e-6), reps=10),
            plain_ms=time_ms(torch, lambda: M.mlp_block_partial_plain(*ma), reps=3),
            library_ms=time_ms(torch, lambda: Fn.linear(Fn.gelu(Fn.linear(
                ma[0], lib_w[0], lib_w[1])), lib_w[2]).float(), reps=10))
        part = M.mlp_block_partial(*ma).view(a[1].shape)
        rl = (a[1], part, *a[5:], 1e-6)
        out[f"residual_ln/{label} MLP half"] = dict(
            shape=list(a[1].shape), tp=tp, flops=10 * T * C,
            bytes=T * C * (2 + 4 + 2) + 3 * C * 4,
            ms=time_ms(torch, lambda: RL.residual_ln(*rl, with_x2=False, transpose=True),
                       reps=10),
            plain_ms=time_ms(torch, lambda: RL.residual_ln_plain(*rl, with_x2=False,
                                                                 transpose=True), reps=3),
            library_ms=time_ms(torch, lambda: Fn.layer_norm(
                a[1].float() + (part + a[5]), (C,), a[6], a[7], 1e-6).transpose(1, 2)
                .contiguous(), reps=10))
        del a, ma, lib_w, part, rl
    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r["flops"], r["bytes"], PEAK_BF16)
        log(f"[tp] timing {name} bf16 x{tuple(r['shape'])} (a rank of tp {tp}): kernel "
            f"{r['ms']:.4f} ms"
            + (f", the whole kernel at these rows {r['whole_ms']:.4f} ms" if "whole_ms" in r
               else "")
            + f", bound {r['bound_ms']:.4f} ms ({r['bound_by']}; {r['flops'] / 1e9:.2f} GFLOP, "
            f"{r['bytes'] / 1e6:.1f} MB), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms")
    return out


def tp_kernel_rows_fp32(torch, Fn, tp=TP):
    """Phase tp (iv), fp32 (the default dtype, in which the
    `D3DP_TRAIN_FUSED=1` tp step runs): K1-tp, K8-tp, K6-tp and K2/K5-tp on
    rank 0's share at the train step's shapes (4 x 243 frames), each timed
    (CUDA events) as the train step calls it, the TF32 plane split of the
    rank's weights included, and split by launch (device time,
    `launch_split`; the plane split under "other"), beside the whole kernel
    at the same rows (its planes made outside the timed calls, as the
    model's weight cache makes them), its plain version, the fp32 library
    sequence for the same work (TF32 off) and its bound at the three-pass
    TF32 rate."""
    from d3dp_tpu_torch.ops import attention as A
    from d3dp_tpu_torch.ops import mlp as M
    from d3dp_tpu_torch.ops import tf32

    f32 = torch.float32
    check(not (torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32),
          "TF32 is on for the fp32 library calls")
    gen = torch.Generator(device="cuda").manual_seed(73)
    heads, cl, hl = HEADS // tp, C // tp, HIDDEN // tp
    scale = (C // HEADS) ** -0.5
    block_kernels = {k: STAGE_KERNELS[k] for k in ("attend", "proj")}
    out = {}

    def timed(name, fn, whole, plain, lib, kernels, **row):
        r = out[name] = dict(row, ms=time_ms(torch, fn, reps=10),
                             whole_ms=time_ms(torch, whole, reps=10),
                             plain_ms=time_ms(torch, plain, reps=3),
                             library_ms=time_ms(torch, lib, reps=10))
        r["launches_ms"] = launch_split(torch, fn, r["ms"], kernels)

    for label, R, N in TRAIN_SHAPES:
        T = R * N
        a = stage_inputs(torch, gen, R, N, f32)
        sa = tp_stage_args(torch, a, tp, 0)
        pa = (tf32.planes(a[1]), tf32.planes(a[3]))
        lib = library_stage_partial(torch, Fn, heads)
        lib_args = (sa[0], sa[1].t().contiguous(), sa[2], sa[5].t().contiguous(), sa[3], sa[4])
        stage_row = dict(
            shape=list(a[0].shape), tp=tp,
            flops=2 * T * C * 3 * cl + 4 * T * N * cl + 2 * T * cl * C,
            bytes=T * C * 4 + (3 * C * cl + cl * C) * 4 + (3 * cl + 2 * C) * 4 + T * C * 4)
        timed(f"attention_stage_partial/train {label}",
              lambda: A.attention_stage_partial(*sa, heads, scale, 1e-6),
              lambda: A.attention_stage(*a, HEADS, scale, 1e-6, planes=pa),
              lambda: A.attention_stage_partial_plain(*sa, heads, scale, 1e-6),
              lambda: lib(*lib_args), STAGE_KERNELS, **stage_row)
        hm = (sa[0], *A.stack_head_major(sa[1], sa[2], heads), *sa[3:])
        whole_hm = (a[0], *A.stack_head_major(a[1], a[2], HEADS), *a[3:])
        pwhm = (tf32.planes(whole_hm[1]), pa[1])
        timed(f"attention_stage_hm_partial/train {label}",
              lambda: A.attention_stage_hm_partial(*hm, heads, scale, 1e-6),
              lambda: A.attention_stage_hm(*whole_hm, HEADS, scale, 1e-6, planes=pwhm),
              lambda: A.attention_stage_hm_partial_plain(*hm, heads, scale, 1e-6),
              lambda: lib(*lib_args), STAGE_KERNELS, **stage_row)
        del a, sa, pa, lib_args, hm, whole_hm, pwhm
        b = block_inputs(torch, gen, R, N, f32)
        qkv_j, wp_j = tp_block_args(torch, b, tp, 0)
        pb = (tf32.planes(b[2]),)
        wp_t = wp_j.t().contiguous()

        def lib_block():
            q, k, v = qkv_j.view(R, N, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)
            o = Fn.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(R, N, cl)
            return Fn.linear(o, wp_t)
        timed(f"attention_block_partial/train {label}",
              lambda: A.attention_block_partial(qkv_j, wp_j, heads, scale),
              lambda: A.attention_block(*b, HEADS, scale, 1e-6, planes=pb),
              lambda: A.attention_block_partial_plain(qkv_j, wp_j, heads, scale),
              lib_block, block_kernels, shape=list(qkv_j.shape), tp=tp,
              flops=4 * T * N * cl + 2 * T * cl * C,
              bytes=T * 3 * cl * 4 + cl * C * 4 + T * C * 4)
        del b, qkv_j, wp_j, pb, wp_t
    T = BT * F * J
    a = mlp_inputs(torch, gen, F, J, f32, rows=BT)
    ma = tp_mlp_args(torch, a, tp, 0)
    pwm = (tf32.planes(a[2]), tf32.planes(a[4]))
    lib_w = (ma[1].t().contiguous(), ma[2], ma[3].t().contiguous())
    timed("mlp_block_partial/train rows", lambda: M.mlp_block_partial(*ma),
          lambda: M.mlp_block_t(*a, 1e-6, planes=pwm), lambda: M.mlp_block_partial_plain(*ma),
          lambda: Fn.linear(Fn.gelu(Fn.linear(ma[0], lib_w[0], lib_w[1])), lib_w[2]),
          {"mlp": "mlp"}, shape=list(ma[0].shape), tp=tp,
          flops=4 * T * C * hl, bytes=T * C * 4 + 2 * C * hl * 4 + hl * 4 + T * C * 4)
    del a, ma, pwm, lib_w
    for name, r in out.items():
        r["bound_ms"], r["bound_by"] = bound_ms(r["flops"], r["bytes"], PEAK_TF32 / 3)
        log(f"[tp] timing {name} fp32 x{tuple(r['shape'])} (rank 0 of tp {tp}): kernel "
            f"{r['ms']:.4f} ms (its weights' TF32 plane split included), the whole kernel at "
            f"these rows {r['whole_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
            f"three TF32 passes; {r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.1f} MB), "
            f"plain {r['plain_ms']:.4f} ms, library (TF32 off) {r['library_ms']:.4f} ms"
            + launches_text(r))
    return out


def tp_eval(torch, mesh, dtype, levels, depth=DEPTH):
    """The Eval config (H=5, K=5, flip-TTA) on one micro-batch of TP_WINDOWS
    windows of a synthetic sequence through the Evaluator at each fuse
    level, in `dtype`, on one noise seed, each after an untimed warm-up
    call (the first of which, under tp, gathers the weights); the weights
    (`depth` blocks) from seed 0 perturbed by seed 1, then split over the
    mesh's tp ranks. Returns {level: (P1 mode -> (K,) list, seconds,
    launches, the prediction on the host)}."""
    from d3dp_tpu_torch.data.generators import UnchunkedGenerator
    from d3dp_tpu_torch.data.synthetic import JOINTS_LEFT, JOINTS_RIGHT, make_dataset
    from d3dp_tpu_torch.diffusion import D3DP
    from d3dp_tpu_torch.eval import MODES, Evaluator
    from d3dp_tpu_torch.parallel import shard_model_params

    dev = torch.device("cuda") if mesh is None else mesh.device
    cfg = main_config(torch)
    d3dp = D3DP(dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dtype=dtype,
                                                                   depth=depth)),
                device=dev, seed=0)
    perturb_(torch, d3dp.model, 1)
    shard_model_params(d3dp.model, mesh)
    preds = []
    sample = d3dp.sample

    def recorded_sample(*a, **k):
        preds.append(sample(*a, **k))
        return preds[-1]
    d3dp.sample = recorded_sample
    data = make_dataset(seed=3, lengths=(TP_WINDOWS * F,))
    ev = Evaluator(d3dp, receptive_field=F, batch_size=TP_WINDOWS, mesh=mesh,
                   kps_left=list(JOINTS_LEFT), kps_right=list(JOINTS_RIGHT))
    out = {}
    for level in levels:
        set_level(d3dp.model, level)
        for _ in range(2):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ev.evaluate(UnchunkedGenerator(*data),
                              torch.Generator(device=dev).manual_seed(21)).averages_mm()
            torch.cuda.synchronize()
        out[level] = ({m: res[m].tolist() for m in MODES}, time.perf_counter() - t0,
                      {n: c for n, c in read_counts().items() if c}, preds[-1].float().cpu())
    return out


TP_LEVELS = {"float32": (4, 5), "bfloat16": (2, 3, 4, 5)}
# the D3DP_TRAIN_FUSED=1 steps at tp=2 (each all-reduces 64 fp32
# activations of 34 MB through the host)
TP_FUSED_STEPS = 2
# the train-fused step's launches at level 4, depth 8, DropPath 0.1 (block 0
# of each kind at rate 0, blocks 1-7 with masks): every block half's
# partial form, its residual_ln (28 with a DropPath scale), and the
# attention core's forward (recomputed by the backward) and backward
TP_FUSED_LAUNCHES = {"attention_stage_partial": 2 * DEPTH, "mlp_block_partial": 2 * DEPTH,
                     "residual_ln": 4 * DEPTH, "residual_ln[dp]": 4 * (DEPTH - 1),
                     "fused_attention_qkv": 2 * DEPTH, "fused_attention_qkv_bwd": 2 * DEPTH}
# one bf16 D3DP_TRAIN_FUSED=1 step on each of the other two partial forms'
# paths, (fuse level, D3DP_ATTN_VARIANT): level 3 runs K6-tp on the two
# blocks at DropPath rate 0 (levels 1-3 compose the others); hmqkv runs
# K8-tp in place of K1-tp
TP_EXTRA = {"level 3": (3, None), "hmqkv": (4, "hmqkv")}
TP_EXTRA_LAUNCHES = {
    "level 3": {"attention_block_partial": 2, "mlp_block_partial": 2, "residual_ln": 4,
                "attention_stage_partial": 0, "residual_ln[dp]": 0},
    "hmqkv": {"attention_stage_hm_partial": 2 * DEPTH, "attention_stage_partial": 0,
              "mlp_block_partial": 2 * DEPTH, "residual_ln": 4 * DEPTH,
              "residual_ln[dp]": 4 * (DEPTH - 1)}}


def tp_extra_steps(torch, mesh):
    """One bf16 `D3DP_TRAIN_FUSED=1` step on each path of TP_EXTRA: {name:
    (losses, seconds, launches)}."""
    out = {}
    with env_var("D3DP_TRAIN_FUSED", "1"):
        for name, (level, variant) in TP_EXTRA.items():
            with env_var("D3DP_ATTN_VARIANT", variant):
                losses, _, step_s, _, _, d3dp = dp_train(torch, mesh, torch.bfloat16, 1, level)
            out[name] = dict(losses=losses, step_s=step_s, launches=dp_train.launches)
            del d3dp
    return out


def tp_rank(out_dir, devices):
    """One rank of phase tp (a spawned process): DP_STEPS train steps (fp32
    and bf16), TP_FUSED_STEPS `D3DP_TRAIN_FUSED=1` steps (fp32 and bf16,
    level 4, DropPath 0.1) and the TP_EXTRA steps, tp_eval (fp32 at levels
    4 and 5, bf16 at 2-5) and tp_eval at bf16 level 4 under
    `D3DP_ATTN_VARIANT=hmqkv` on a (dp=1, tp=TP) mesh over `devices`,
    training against the one-process reference in out_dir/ref.pt; one fp32
    activation's all-reduce timed; the report to out_dir/rank<r>.json and
    the predictions to out_dir/rank<r>.pt."""
    import torch
    import torch.distributed as dist

    from d3dp_tpu_torch import disable_tf32
    from d3dp_tpu_torch.parallel import make_mesh

    disable_tf32()
    mesh = make_mesh(dp=1, tp=TP, devices=devices)
    ref = torch.load(os.path.join(out_dir, "ref.pt"), weights_only=False)
    train, d3dp = dp_train_rep(torch, mesh, ref["train"])
    del d3dp
    with env_var("D3DP_TRAIN_FUSED", "1"):
        fused, d3dp = dp_train_rep(torch, mesh, ref["fused"], steps=TP_FUSED_STEPS)
    del d3dp
    extra = tp_extra_steps(torch, mesh)
    # gloo's rate: one block half's fp32 partial at the eval rows, all-reduced
    # over the group (the training tp flows all-reduce such activations)
    act = torch.zeros(TP_ROWS * F * J * C, device=mesh.device)
    dist.all_reduce(act, group=mesh.tp_group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        dist.all_reduce(act, group=mesh.tp_group)
    torch.cuda.synchronize()
    act_s = (time.perf_counter() - t0) / 5
    evals, preds = {}, {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        ev = tp_eval(torch, mesh, dt, TP_LEVELS[name])
        evals[name] = {str(lv): v[:3] for lv, v in ev.items()}
        preds[name] = {lv: v[3] for lv, v in ev.items()}
    with env_var("D3DP_ATTN_VARIANT", "hmqkv"):
        ev = tp_eval(torch, mesh, torch.bfloat16, (4,))[4]
    hm = ev[:3]
    preds["bfloat16"]["hm"] = ev[3]
    rep = dict(rank=mesh.rank, device=str(mesh.device), train=train, eval=evals, fused=fused,
               extra=extra, hm=hm, act_allreduce_s=act_s, act_bytes=act.numel() * 4)
    with open(os.path.join(out_dir, f"rank{mesh.rank}.json"), "w") as f:
        json.dump(rep, f)
    torch.save(preds, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def check_tp_ranks(torch, out_dir, ref_eval, record):
    """Phase tp (ii) and (iii): read and hold the ranks' reports. Training
    as phase dp holds it (`check_dp_ranks`), every bf16 loss at
    BF16_LOSS_TOL; the evaluator at fp32 levels 4 and 5 and bf16 levels
    2-5 equal to one process: the predictions bit for bit, the four modes
    and the launches a call the same (each level's whole kernels,
    LEVEL_KERNELS, 2 x depth x K a call, K9 K; no tp form); 16 K3 + 16 K4
    a train step."""
    reps = []
    for r in range(TP):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            rep = json.load(f)
        preds = torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
        reps.append(rep)
        t32, t16 = rep["train"]["float32"], rep["train"]["bfloat16"]
        # bf16: unlike phase dp's row split, the tp forward itself rounds
        # differently (the row-parallel products summed in fp32, not each
        # rounded to bf16 once), so the first loss is held as the later ones
        ok_train = (max(t32["loss_rel"]) <= 1e-5 and t32["param_rel_l2"] <= 1e-3
                    and max(t16["loss_rel"]) <= BF16_LOSS_TOL
                    and t16["param_rel_l2"] <= 1e-3 and t32["finite"] and t16["finite"]
                    and all(math.isfinite(v) for v in t16["losses"]))
        ok_steps = all(tuple(c) == (2 * DEPTH, 2 * DEPTH) for t in (t32, t16)
                       for c in t["step_counts"])
        held = []
        for name, levels in TP_LEVELS.items():
            for lv in levels:
                modes, secs, counts = rep["eval"][name][str(lv)]
                want = {k: per_forward(lv) * K for k in LEVEL_KERNELS[lv]}
                held.append(dict(
                    what=f"{name} level {lv}", seconds=secs, counts=counts,
                    equal=torch.equal(preds[name][lv], ref_eval[name][lv][3]),
                    modes_equal=modes == ref_eval[name][lv][0],
                    launches_ok=counts == want == ref_eval[name][lv][2]))
        ok_eval = all(h["equal"] and h["modes_equal"] and h["launches_ok"] for h in held)
        ok = ok_train and ok_steps and ok_eval
        for name, t in (("fp32", t32), ("bf16", t16)):
            log(f"[tp] rank {r} on {rep['device']}: {name} train losses "
                f"{' '.join(f'{v:.6f}' for v in t['losses'])}; against one process: losses "
                f"{' '.join(f'{v:.2e}' for v in t['loss_rel'])} relative, parameters relative "
                f"L2 {t['param_rel_l2']:.3e} (every parameter {t['param_rel_l2_all']:.3e}; "
                f"max|diff| / max|p| {t['param_rel_max']:.3e}); s/step "
                f"{' '.join(f'{v:.4f}' for v in t['step_s'])}; K3/K4 a step {t['step_counts']}")
        for h in held:
            log(f"[tp] rank {r}: evaluator {h['what']}: prediction equal to one process's "
                f"{h['equal']}, four modes equal {h['modes_equal']}; launches a call "
                f"{h['counts']} (one process's, no tp form: {h['launches_ok']}); "
                f"s/micro-batch ({TP_WINDOWS} window, {TP_ROWS} rows) {h['seconds']:.4f}")
        log(f"[tp] rank {r}: train {ok_train}, steps {ok_steps}, evaluation {ok_eval}; one fp32 "
            f"activation all-reduce ({rep['act_bytes'] / 1e6:.1f} MB, gloo) "
            f"{rep['act_allreduce_s'] * 1e3:.2f} ms = "
            f"{rep['act_allreduce_s'] * 1e3 / (rep['act_bytes'] / 1e6):.3f} ms/MB "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"phase tp: rank {r} disagrees with one process or miscounts launches")
    same = all(reps[0]["train"][n]["losses"] == reps[1]["train"][n]["losses"]
               for n in ("float32", "bfloat16"))
    same = same and all(reps[0]["eval"][n][lv][0] == reps[1]["eval"][n][lv][0]
                        for n in reps[0]["eval"] for lv in reps[0]["eval"][n])
    check(same, "phase tp: the ranks' losses or metrics differ")
    record["tp"] = dict(ranks=reps)


def check_tp_last_paths(torch, out_dir, ref_extra, ref_hm, record):
    """Phase tp (v) and (vi): the ranks' `D3DP_TRAIN_FUSED=1` steps held as
    phase dp holds training (fp32 losses 1e-5 relative, parameters 1e-3
    relative L2; bf16 losses at BF16_LOSS_TOL), with the launches of
    TP_FUSED_LAUNCHES a step; the TP_EXTRA steps' losses at BF16_LOSS_TOL of
    one process's, with TP_EXTRA_LAUNCHES; the bf16 hmqkv level-4
    evaluator's prediction equal bit for bit to one process's, with 80 K8
    and 80 K2 a call and no tp form; the ranks equal. Returns rank 0's
    launches of the tp forms on these steps (bf16)."""
    per_call = 2 * DEPTH * K
    reps, launches = [], {}
    for r in range(TP):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            rep = json.load(f)
        preds = torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
        reps.append(rep)
        f32, f16 = rep["fused"]["float32"], rep["fused"]["bfloat16"]
        ok_train = (max(f32["loss_rel"]) <= 1e-5 and f32["param_rel_l2"] <= 1e-3
                    and max(f16["loss_rel"]) <= BF16_LOSS_TOL and f16["param_rel_l2"] <= 1e-3
                    and f32["finite"] and f16["finite"])
        ok_fused_launch = all(t["launches"] == TP_FUSED_LAUNCHES for t in (f32, f16))
        extra = rep["extra"]
        extra_rel = {n: abs(e["losses"][0] - ref_extra[n]["losses"][0])
                     / abs(ref_extra[n]["losses"][0]) for n, e in extra.items()}
        ok_extra = all(extra_rel[n] <= BF16_LOSS_TOL and all(
            e["launches"].get(k, 0) == v for k, v in TP_EXTRA_LAUNCHES[n].items())
            for n, e in extra.items())
        h16 = rep["hm"]
        equal_hm = torch.equal(preds["bfloat16"]["hm"], ref_hm[3])
        c = h16[2]
        ok_hm = (equal_hm and h16[0] == ref_hm[0]
                 and c == {"attention_stage_hm": per_call, "mlp_block_t": per_call} == ref_hm[2])
        for name, t in (("fp32", f32), ("bf16", f16)):
            log(f"[tp] rank {r}: {name} D3DP_TRAIN_FUSED=1 (level 4, DropPath 0.1) train losses "
                f"{' '.join(f'{v:.6f}' for v in t['losses'])}; against one process: losses "
                f"{' '.join(f'{v:.2e}' for v in t['loss_rel'])} relative, parameters relative "
                f"L2 {t['param_rel_l2']:.3e} (every parameter {t['param_rel_l2_all']:.3e}); "
                f"s/step {' '.join(f'{v:.4f}' for v in t['step_s'])}; launches a step "
                f"{t['launches']}")
        for n, e in extra.items():
            log(f"[tp] rank {r}: bf16 D3DP_TRAIN_FUSED=1 step ({n}) loss {e['losses'][0]:.6f}, "
                f"{extra_rel[n]:.2e} relative of one process's; {e['step_s'][0]:.4f} s; "
                f"launches {e['launches']}")
        log(f"[tp] rank {r}: hmqkv evaluator bf16 level 4 prediction equal to one process's "
            f"{equal_hm}; s/micro-batch {h16[1]:.4f}; launches a call {c}; train {ok_train}, "
            f"train launches {ok_fused_launch}, extra steps {ok_extra}, hmqkv {ok_hm} "
            f"{'ok' if ok_train and ok_fused_launch and ok_extra and ok_hm else 'FAIL'}")
        check(ok_train and ok_fused_launch and ok_extra and ok_hm,
              f"phase tp: rank {r}'s train-fused or hmqkv run disagrees with one process or "
              "miscounts launches")
        if r == 0:
            launches.update({k: f16["launches"].get(k, 0) for k in (
                "attention_stage_partial", "mlp_block_partial", "residual_ln",
                "residual_ln[dp]")},
                attention_block_partial=extra["level 3"]["launches"]["attention_block_partial"],
                attention_stage_hm_partial=extra["hmqkv"]["launches"][
                    "attention_stage_hm_partial"])
    same = all(reps[0]["fused"][n]["losses"] == reps[1]["fused"][n]["losses"]
               for n in ("float32", "bfloat16")) and reps[0]["hm"][0] == reps[1]["hm"][0]
    same = same and all(reps[0]["extra"][n]["losses"] == reps[1]["extra"][n]["losses"]
                        for n in TP_EXTRA)
    check(same, "phase tp: the ranks' train-fused losses or hmqkv metrics differ")
    log("[tp] " + json.dumps({"tp_launches": [
        {"rank": rep["rank"], "train_fused": rep["fused"]["bfloat16"]["launches"],
         **{n: e["launches"] for n, e in rep["extra"].items()},
         "eval": {f"{n} level {lv}": e[2] for n, es in rep["eval"].items()
                  for lv, e in es.items()}, "eval hmqkv": rep["hm"][2]} for rep in reps]}))
    return launches


def phase_tp(torch, record, errs, rows):
    """Tensor parallelism (`--tp`, parallel/mesh.py's split, parallel/tp.py,
    the partial forms and residual_ln) at the published width:
      (i) K1-tp, K8-tp, K6-tp, K2/K5-tp and residual_ln (with and without
          its DropPath scale) against their plain versions at tp 2, 4 and 8
          and at the tiles' edges, the partials' sums against the whole
          kernels (K8, and K1-dp, K2-dp, K5-dp through residual_ln's
          DropPath form; `check_tp_kernels`), and each timed at a rank's
          rows (`tp_kernel_rows`, into `rows`; in fp32 at the train step's
          shapes, `tp_kernel_rows_fp32`);
      (ii) two ranks sharing the card over gloo at tp=2: the Eval config on
          one window (10 hypothesis rows), fp32 at levels 4 and 5 and bf16
          at levels 2-5, equal to one process on the same weights and noise
          (the whole kernels on the gathered weights);
      (iii) DP_STEPS train steps at tp=2, fp32 and bf16, against one
          process at phase dp's rules (the first bf16 loss too at
          BF16_LOSS_TOL: the tp forward rounds otherwise in bf16);
      (iv) each rank's seconds per step and per micro-batch and the fp32
          activation all-reduce's ms per MB;
      (v) TP_FUSED_STEPS `D3DP_TRAIN_FUSED=1` steps at tp=2 (level 4,
          DropPath 0.1: K1-tp and K2-tp with their backwards, residual_ln
          with the DropPath scale), fp32 and bf16, against one process at
          phase dp's rules, with TP_FUSED_LAUNCHES a step; one bf16 step
          at level 3 (K6-tp) and one under hmqkv (K8-tp), TP_EXTRA;
      (vi) the Eval config's window at bf16 level 4 under hmqkv (K8 on the
          gathered weights), equal bit for bit to one process's.
    Returns the ranks' launches of the tp forms (rank 0's)."""
    import torch.nn.functional as Fn

    from d3dp_tpu_torch.parallel import spawn

    t_phase = time.perf_counter()
    check_tp_kernels(torch, errs)
    rows.update(tp_kernel_rows(torch, Fn))
    record["tp_kernel_rows_fp32"] = tp_kernel_rows_fp32(torch, Fn)
    ref = {}
    for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        losses, params, step_s, _, key_grads, d3dp = dp_train(torch, None, dt)
        ref[name] = dict(losses=losses, params=params, key_grads=key_grads)
        log(f"[tp] one process {name}: train losses {' '.join(f'{v:.6f}' for v in losses)}, "
            f"s/step {' '.join(f'{v:.4f}' for v in step_s)}")
        del d3dp
    ref_fused = {}
    with env_var("D3DP_TRAIN_FUSED", "1"):
        for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            losses, params, step_s, _, key_grads, d3dp = dp_train(torch, None, dt, TP_FUSED_STEPS)
            ref_fused[name] = dict(losses=losses, params=params, key_grads=key_grads)
            log(f"[tp] one process {name} D3DP_TRAIN_FUSED=1: train losses "
                f"{' '.join(f'{v:.6f}' for v in losses)}, s/step "
                f"{' '.join(f'{v:.4f}' for v in step_s)}")
            del d3dp
    ref_extra = tp_extra_steps(torch, None)
    ref_eval = {name: tp_eval(torch, None, dt, TP_LEVELS[name])
                for name, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16))}
    with env_var("D3DP_ATTN_VARIANT", "hmqkv"):
        ref_hm = tp_eval(torch, None, torch.bfloat16, (4,))[4]
    log(f"[tp] one process: s/micro-batch ({TP_WINDOWS} window) fp32 level 4 "
        f"{ref_eval['float32'][4][1]:.4f} level 5 {ref_eval['float32'][5][1]:.4f}; bf16 levels "
        f"2-5 " + " ".join(f"{ref_eval['bfloat16'][lv][1]:.4f}" for lv in (2, 3, 4, 5))
        + f", hmqkv {ref_hm[1]:.4f}; bf16 D3DP_TRAIN_FUSED=1 step "
        + ", ".join(f"{n} {e['step_s'][0]:.4f} s (loss {e['losses'][0]:.6f})"
                    for n, e in ref_extra.items()))
    out_dir = os.path.join(os.getcwd(), "log", "chip_smoke_tp")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    torch.save(dict(train=ref, fused=ref_fused), os.path.join(out_dir, "ref.pt"))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn(tp_rank, TP, out_dir, ["cuda:0"] * TP, backend="gloo")
    log(f"[tp] two ranks on one card over gloo: {time.perf_counter() - t0:.1f} s with the "
        "processes' start")
    check_tp_ranks(torch, out_dir, ref_eval, record)
    launches = check_tp_last_paths(torch, out_dir, ref_extra, ref_hm, record)
    shutil.rmtree(out_dir, ignore_errors=True)
    record["tp"]["seconds"] = time.perf_counter() - t_phase
    log(f"[tp] phase tp: {record['tp']['seconds']:.1f} s")
    return launches


def tp_depth_rank(out_dir, devices, depth):
    """One rank of the `--tp-depth` probe: tp_eval in fp32 at level 4 and
    `depth`, without and with hmqkv; the results to out_dir/rank<r>.pt."""
    import torch

    from d3dp_tpu_torch import disable_tf32
    from d3dp_tpu_torch.parallel import make_mesh

    disable_tf32()
    mesh = make_mesh(dp=1, tp=TP, devices=devices)
    out = {}
    for variant in (None, "hmqkv"):
        with env_var("D3DP_ATTN_VARIANT", variant):
            out[variant] = tp_eval(torch, mesh, torch.float32, (4,), depth)[4]
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))


def fp32_rows_only(torch):
    """The `--fp32-rows` run (module docstring)."""
    import torch.nn.functional as Fn

    from d3dp_tpu_torch import disable_tf32

    disable_tf32()
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60,
                       check=True).stdout.strip().splitlines()[0])
    out = dict(tp_kernel_rows_fp32=tp_kernel_rows_fp32(torch, Fn),
               group_rows_fp32=group_rows_fp32(torch, Fn),
               sample_seconds_fp32=group_sample_fp32(torch))
    log("RESULT " + json.dumps(out))
    return 0


def group_sample_fp32(torch, groups=(0, 8), reps=3):
    """One fp32 D3DP.sample at the eval config at fuse level 4 (random
    weights from seed 0) ungrouped and under each `D3DP_SPATIAL_GROUP` in
    groups: seconds a call, the median of `reps` after a warm-up call."""
    from d3dp_tpu_torch.diffusion import D3DP

    cfg = main_config(torch)
    d3dp = D3DP(dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, dtype=torch.float32)), seed=0)
    set_level(d3dp.model, 4)
    g = torch.Generator(device="cuda").manual_seed(9)
    x2d = torch.randn(B, F, J, 2, generator=g, device="cuda") * 0.3
    x2d_f = torch.randn(B, F, J, 2, generator=g, device="cuda") * 0.3
    out = {}
    for group in groups:
        with env_vars({"D3DP_SPATIAL_GROUP": str(group)} if group else {}):
            out[f"group{group}" if group else "ungrouped"] = time_ms(
                torch, lambda: d3dp.sample(x2d, x2d_f, generator=g), reps) / 1e3
    log(f"[fp32-rows] D3DP.sample B={B} H={H} K={K} F={F} fp32 flip-TTA level 4: " + ", ".join(
        f"{k} {v:.4f} s/call" for k, v in out.items()) + f" (median of {reps})")
    return out


def tp_depth_probe(torch, depth):
    """The `--tp-depth` probe (module docstring): returns 0 once it has
    printed its readings, whatever they are."""
    from d3dp_tpu_torch import disable_tf32
    from d3dp_tpu_torch.parallel import spawn

    disable_tf32()
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60,
                       check=True).stdout.strip().splitlines()[0])
    ref = tp_eval(torch, None, torch.float32, (4,), depth)[4]
    out_dir = os.path.join(os.getcwd(), "log", "chip_smoke_tp_depth")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    spawn(tp_depth_rank, TP, out_dir, ["cuda:0"] * TP, depth, backend="gloo")
    readings = []
    for r in range(TP):
        got = torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
        for variant, (modes, secs, _, pred) in got.items():
            pairs = [(a, b) for m, v in modes.items() for a, b in zip(v, ref[0][m])]
            readings.append(dict(rank=r, variant=variant or "", depth=depth,
                                 mode_gap_mm=max(abs(a - b) for a, b in pairs),
                                 mode_max_mm=max(abs(b) for _, b in pairs),
                                 equal=torch.equal(pred, ref[3]),
                                 pred_l2_gap=(pred - ref[3]).norm().item(), seconds=secs))
        log(f"[tp-depth] rank {r}, depth {depth}, fp32 level 4: four modes max|diff| to one "
            f"process " + ", ".join(f"{x['variant'] or 'K1'} {x['mode_gap_mm']:.3e} mm "
                                    f"(prediction equal {x['equal']})"
                                    for x in readings if x["rank"] == r)
            + f" at modes up to {readings[-1]['mode_max_mm']:.3f} mm")
    shutil.rmtree(out_dir, ignore_errors=True)
    log(json.dumps({"tp_depth": readings}))
    return 0


def kernels_line(rows, errs, launches):
    """One entry per kernel; times are the mean of its shapes on its path,
    which the path launches equally often. Launches: K1 and K2 from the
    evaluation path's run (phase main), K3 and K4 from the training path's
    (phase train), K5 and K6 from the command line's evaluation at the fuse
    levels that run them (phase cli), K7 from its public op (phase packed),
    K9 from one D3DP.sample call at fuse level 5 (phase resident), K1-dp
    and K2-dp from the train-fused steps (phase train_fused), K5-dp from its
    public op (phase public_dp), K8 from one D3DP.sample call with hmqkv
    (phase hmqkv); each lab-switch instantiation from its path in phase
    lab_switches (`phase_lab_switches`); the tensor-parallel forms from
    rank 0's `D3DP_TRAIN_FUSED=1` steps in phase tp (evaluation under tp
    runs the whole kernels on the gathered weights): K1-tp, K2/K5-tp,
    residual_ln and its DropPath form from the last bf16 level-4 step, K6-tp
    from the level-3 step, K8-tp from the hmqkv step, each timed at a
    rank's eval rows (residual_ln's DropPath form at the train step's
    shapes)."""
    meta = {"attention_stage": ("d3dp_tpu_torch/ops/csrc/attention_stage.cu",
                                "d3dp_tpu/ops/attention.py:396"),
            "mlp_block_t": ("d3dp_tpu_torch/ops/csrc/mlp_block_t.cu",
                            "d3dp_tpu/ops/mlp.py:156"),
            "fused_attention_qkv": ("d3dp_tpu_torch/ops/csrc/attention_qkv.cu",
                                    "d3dp_tpu/ops/attention.py:69"),
            "fused_attention_qkv_bwd": ("d3dp_tpu_torch/ops/csrc/attention_qkv.cu",
                                        "d3dp_tpu/ops/attention.py:133"),
            "mlp_block": ("d3dp_tpu_torch/ops/csrc/mlp_block_t.cu", "d3dp_tpu/ops/mlp.py:80"),
            "attention_block": ("d3dp_tpu_torch/ops/csrc/attention_block.cu",
                                "d3dp_tpu/ops/attention.py:227"),
            "fused_attention_packed": ("d3dp_tpu_torch/ops/csrc/attention_qkv.cu",
                                       "d3dp_tpu/ops/attention.py:32"),
            "resident_block_stack": ("d3dp_tpu_torch/ops/csrc/resident.cu",
                                     "d3dp_tpu/ops/resident.py:118"),
            "attention_stage_dp": ("d3dp_tpu_torch/ops/csrc/attention_stage.cu",
                                   "d3dp_tpu/ops/attention.py:974"),
            "mlp_block_t_dp": ("d3dp_tpu_torch/ops/csrc/mlp_block_t.cu",
                               "d3dp_tpu/ops/mlp.py:397"),
            "mlp_block_dp": ("d3dp_tpu_torch/ops/csrc/mlp_block_t.cu", "d3dp_tpu/ops/mlp.py:378"),
            "attention_stage_hm": ("d3dp_tpu_torch/ops/csrc/attention_stage.cu",
                                   "d3dp_tpu/ops/attention.py:480"),
            # the tensor-parallel forms (phase tp), on the train-fused tp
            # step: each stands in for the TPU kernel that XLA runs on
            # gathered operands under --tp
            "attention_stage_partial": ("d3dp_tpu_torch/ops/csrc/attention_stage.cu",
                                        "d3dp_tpu/ops/attention.py:396"),
            "attention_block_partial": ("d3dp_tpu_torch/ops/csrc/attention_block.cu",
                                        "d3dp_tpu/ops/attention.py:227"),
            "mlp_block_partial": ("d3dp_tpu_torch/ops/csrc/mlp_block_t.cu",
                                  "d3dp_tpu/ops/mlp.py:156"),
            "residual_ln": ("d3dp_tpu_torch/ops/csrc/residual_ln.cu",
                            "d3dp_tpu/ops/mlp.py:156"),
            # K8-tp (hmqkv under --tp) and residual_ln's DropPath form
            # (where K1-dp and K2-dp run on gathered operands in JAX)
            "attention_stage_hm_partial": ("d3dp_tpu_torch/ops/csrc/attention_stage.cu",
                                           "d3dp_tpu/ops/attention.py:480"),
            "residual_ln[dp]": ("d3dp_tpu_torch/ops/csrc/residual_ln.cu",
                                "d3dp_tpu/ops/attention.py:974")}
    # each lab-switch instantiation (phase lab_switches): the source of the
    # kernel it runs, the line of the TPU kernel's switch
    meta.update({name: (meta[name.split("[")[0]][0], rep) for name, (_, rep) in LAB.items()})
    out = []
    for name, (src, rep) in meta.items():
        rs = [r for k, r in rows.items() if k.startswith(name + "/")]

        def mean(key):
            vals = [r[key] for r in rs]
            return None if None in vals else sum(vals) / len(vals)
        bound_by = "operations" if all(r["bound_by"] == "operations" for r in rs) else "bytes"
        out.append({"name": name, "route": "cuda", "source": src, "replaces": rep,
                    "launches": launches[name], "max_abs_err": errs[name], "ms": mean("ms"),
                    "plain_ms": mean("plain_ms"), "bound_ms": mean("bound_ms"),
                    "bound_by": bound_by, "library_ms": mean("library_ms")})
    return {"kernels": out}


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke run of the port on one CUDA card.")
    ap.add_argument("--tp-depth", type=int, metavar="N",
                    help="run only the tensor-parallel rounding probe at depth N")
    ap.add_argument("--fp32-rows", action="store_true",
                    help="time only the fp32 tensor-parallel and grouped K1 rows")
    ap.add_argument("--fp32-truth", action="store_true",
                    help="run only phase env and the fp32 walks' distance from float64")
    ap.add_argument("--linear", action="store_true",
                    help="run only phase env, the tf32x3 linears' rows and the fp32 train steps")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 2
    if args.tp_depth:
        return tp_depth_probe(torch, args.tp_depth)
    if args.fp32_rows:
        return fp32_rows_only(torch)
    if args.fp32_truth:
        phase_env(torch, {})
        log("RESULT " + json.dumps(phase_fp32_truth(torch, {})))
        return 0
    if args.linear:
        record = {}
        phase_env(torch, record)
        out, fails = linear_rows(torch)
        train_fp32(torch, record)
        log("RESULT " + json.dumps(dict(linear=out, train_fp32=record["train_fp32"])))
        check(not fails, "linear rows: " + "; ".join(fails))
        return 0
    record = {}
    t_all = time.perf_counter()
    os.makedirs("chiprun_out", exist_ok=True)
    phase_env(torch, record)
    probe_resident(torch)
    errs = phase_kernels(torch, record)
    phase_model(torch, record)
    phase_train_model(torch, record)
    d3dp, x2d, x2d_f, _ = phase_main(torch, record)
    phase_p2_device(torch, record, d3dp)
    rows = phase_timing(torch, record, d3dp, x2d, x2d_f)
    phase_profile(torch, record, d3dp, x2d, x2d_f)
    phase_fuse_levels(torch, record, d3dp, x2d, x2d_f)
    phase_fp32_truth(torch, record)
    phase_resident(torch, record, d3dp, x2d, x2d_f, rows)
    phase_hmqkv(torch, record, d3dp, x2d, x2d_f)
    phase_call_args(torch, record, d3dp, x2d, x2d_f)
    phase_train(torch, record)
    phase_train_fused(torch, record)
    phase_packed(torch, record)
    phase_public_dp(torch, record)
    lab_errs, lab_launches = phase_lab_switches(torch, record, d3dp, x2d, x2d_f, rows)
    errs.update(lab_errs)
    record["launches"].update(lab_launches)
    del d3dp
    phase_cli(torch, record)
    phase_host(torch, record)
    phase_cli_3dhp(torch, record)
    phase_wild(torch, record)
    phase_dp(torch, record, errs)
    record["launches"].update(phase_tp(torch, record, errs, rows))
    line = kernels_line(rows, errs, record["launches"])
    record["kernels"] = line["kernels"]
    record["seconds"] = time.perf_counter() - t_all
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"[done] all phases passed in {record['seconds']:.1f} s")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

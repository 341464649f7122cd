"""fp32 linear layers on the tensor cores in three TF32 passes.

`linear(x, w, b)` is `F.linear` for the composed block's four linears
(`models/mixste.py`: qkv, proj, fc1, fc2). Where the call is fp32 on a card
and the shapes fit the kernel (`routes`: K % 32 == 0, N % 128 == 0) it runs
`LinearTF32x3`, whose forward and input gradient are the hand-written
tf32x3 GEMM (`csrc/linear_tf32x3.cu`); everything else stays on `F.linear`
as it was: bf16 (cuBLAS's tensor-core kernels already), CPU tensors, shapes
the kernel does not take. Nothing selects it but the call's own dtype,
device and shapes.

`LinearTF32x3` (x (..., K), w (N, K) in nn.Linear's layout, b (N,) or
None):
  * forward: y = x @ w^T + b on B = w's TF32 hi and lo planes (2, N, K);
  * input gradient: dx = dy @ w on B = w^T's planes (2, K, N), on the
    kernel where its shape fits too (K % 128 == 0, N % 32 == 0), else a
    plain product;
  * weight and bias gradients: dw = dy^T @ x and db = dy summed over the
    rows, plain torch ops (cuBLAS).
The planes come from one split launch a call (`split_planes`: both
orientations at once where the input gradient is wanted), so a weight is
split once a training step, after the optimizer changed it. The products
keep fp32's accuracy: each operand v splits into hi = tf32(v) and lo =
tf32(v - hi), each k-step adds lo hi, hi lo and hi hi, and each 32-k stage's
products are summed apart and added to the result in fp32 (`csrc/mlp.cuh`,
"fp32: tf32x3"). `torch.backends.cuda.matmul.allow_tf32` is not read or
touched.

On a CUDA tensor `gemm` and `split_planes` launch their kernels; on a CPU
tensor they run `gemm_plain` and `split_planes_plain`, which repeat the
kernels' arithmetic (the tests hold them to `F.linear`).

Launch counts: `gemm.launches` and `split_planes.launches`; each GEMM
launch also counts `linear_tf32x3` on the recorder
(`utils/profiling.py`), 128 a composed fp32 training step at the
published depth (64 forward, 64 input gradients).
"""

import ctypes

import torch
import torch.nn.functional as F

from d3dp_tpu_torch.ops import _build
from d3dp_tpu_torch.ops.tf32 import round_tf32
from d3dp_tpu_torch.utils import profiling

_P, _I = ctypes.c_void_p, ctypes.c_int
_FNS = {"d3dp_linear_tf32x3": [_P] * 4 + [_I] * 3 + [_P],
        "d3dp_tf32_planes": [_P] * 3 + [_I] * 2 + [_P]}

COLS, K_STEP = 128, 32  # the kernel's output columns a tile and k a stage


def fits(N, K):
    """Whether the GEMM takes a product of N output columns over K."""
    return N % COLS == 0 and K % K_STEP == 0 and N > 0 and K > 0


def routes(x, w):
    """Whether `linear` sends F.linear(x, w, ...) to the kernel: fp32
    operands on a card, w (N, K) with N % 128 == 0 and K % 32 == 0."""
    return (x.is_cuda and x.dtype == torch.float32 and w.dtype == torch.float32
            and w.dim() == 2 and x.shape[-1] == w.shape[1] and fits(*w.shape))


def linear(x, w, b=None):
    """F.linear(x, w, b), on the tf32x3 kernel where `routes` says so."""
    if routes(x, w):
        return LinearTF32x3.apply(x, w, b)
    return F.linear(x, w, b)


def split_planes_plain(w, transposed=False):
    """(hi and lo planes of w (N, K): (2, N, K); those of w^T (2, K, N), or
    None), rounded as `ops.tf32.planes` rounds."""
    hi = round_tf32(w)
    p = torch.stack((hi, round_tf32(w - hi)))
    return p, p.transpose(1, 2).contiguous() if transposed else None


def _launch(what, fn, dev, *args):
    """The library's entry point fn(*args, stream) on dev's current stream,
    dev current. The composed step makes 192 such calls, and its forward is
    paced by the host: the raw stream handle and the device switch only
    where needed take about 11 us off each call (PERF.md)."""
    lib = _build.load("linear_tf32x3", _FNS)
    if torch.cuda.current_device() != dev.index:
        with torch.cuda.device(dev):
            return _launch(what, fn, dev, *args)
    _build.check(getattr(lib, fn)(*args, torch._C._cuda_getCurrentRawStream(dev.index)), what)


def _ptr(t):
    return None if t is None else t.data_ptr()


def split_planes(w, transposed=False):
    """`split_planes_plain`'s planes; on a card one launch makes both."""
    if w.device.type == "cpu":
        return split_planes_plain(w, transposed)
    N, K = w.shape
    _build.check_operand(w, "w", torch.float32, (N, K), w.device)
    p = torch.empty((2, N, K), dtype=torch.float32, device=w.device)
    pt = torch.empty((2, K, N), dtype=torch.float32, device=w.device) if transposed else None
    _launch("split_planes", "d3dp_tf32_planes", w.device, w.data_ptr(), p.data_ptr(), _ptr(pt),
            N, K)
    split_planes.launches += 1
    return p, pt


def gemm_plain(a, planes, bias=None):
    """a (M, K) @ B^T (+ bias) from B's planes (2, N, K) in the kernel's
    arithmetic: a split into hi and lo, each 32-k stage's lo hi + hi lo + hi
    hi summed apart and added to the result in fp32."""
    ah = round_tf32(a)
    al = round_tf32(a - ah)
    bh, bl = planes[0], planes[1]
    out = torch.zeros(a.shape[0], planes.shape[1], dtype=torch.float32, device=a.device)
    for k in range(0, a.shape[1], K_STEP):
        s = slice(k, k + K_STEP)
        out = out + (al[:, s] @ bh[:, s].t() + ah[:, s] @ bl[:, s].t() + ah[:, s] @ bh[:, s].t())
    return out if bias is None else out + bias


def gemm(a, planes, bias=None):
    """a (M, K) fp32 @ B^T (+ bias (N,)) with B (N, K) given as its planes
    (2, N, K): the kernel on a card, `gemm_plain` on the CPU."""
    if a.device.type == "cpu":
        return gemm_plain(a, planes, bias)
    M, K = a.shape
    N = planes.shape[1]
    if not fits(N, K):
        raise ValueError(f"gemm: needs N % {COLS} == 0 and K % {K_STEP} == 0 (N={N}, K={K})")
    dev, f32 = a.device, torch.float32
    _build.check_operand(a, "a", f32, (M, K), dev)
    _build.check_operand(planes, "planes", f32, (2, N, K), dev)
    if bias is not None:
        _build.check_operand(bias, "bias", f32, (N,), dev)
    y = torch.empty((M, N), dtype=f32, device=dev)
    _launch("gemm", "d3dp_linear_tf32x3", dev, a.data_ptr(), planes.data_ptr(), _ptr(bias),
            y.data_ptr(), M, N, K)
    gemm.launches += 1
    profiling.count("linear_tf32x3")
    return y


gemm.launches = 0
split_planes.launches = 0


class LinearTF32x3(torch.autograd.Function):
    """F.linear with the forward and the input gradient on `gemm`; see the
    module docstring."""

    @staticmethod
    def forward(ctx, x, w, b):
        N, K = w.shape
        lead = x.shape[:-1]
        x2 = x.reshape(-1, K).contiguous()
        dx_on_kernel = ctx.needs_input_grad[0] and fits(K, N)
        p, pt = split_planes(w.contiguous(), transposed=dx_on_kernel)
        y = gemm(x2, p, None if b is None else b.contiguous())
        ctx.save_for_backward(x2, w, pt)
        ctx.lead, ctx.has_bias = lead, b is not None
        return y.view(*lead, N)

    @staticmethod
    def backward(ctx, dy):
        x2, w, pt = ctx.saved_tensors
        N, K = w.shape
        dy2 = dy.reshape(-1, N).contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            dx = (gemm(dy2, pt) if pt is not None else dy2 @ w).view(*ctx.lead, K)
        if ctx.needs_input_grad[1]:
            dw = dy2.t() @ x2
        if ctx.has_bias and ctx.needs_input_grad[2]:
            db = dy2.sum(0)
        return dx, dw, db

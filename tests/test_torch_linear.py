"""The block linears' tf32x3 path (`ops.linear`) on the CPU.

`LinearTF32x3`'s forward and input gradient run the tf32x3 GEMM, on the
CPU its plain version (`gemm_plain`: the kernel's split, per-k-step pass
order and per-32-k promotion in plain torch), with the weight split by
`split_planes_plain`; its weight and bias gradients are plain products.
Held here against `F.linear` and float64 at ragged row counts (17, 129 and
268 = 2 x 128 + 12, the train step's 16,524 = 129 x 128 + 12 cut to a CPU
size) and the block widths (K in {512, 1024}, N in {512, 1024, 1536}).
`linear` sends only fp32 calls on a card whose shapes fit the kernel to it;
on the CPU the composed train step is what it was, bit for bit. The
kernels themselves are held to float64 and cuBLAS on the card
(tests/test_torch_kernels.py, chip_smoke.py).
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.models import MixSTEConfig
from d3dp_tpu_torch.models import mixste
from d3dp_tpu_torch.ops import linear as L
from d3dp_tpu_torch.ops import tf32
from d3dp_tpu_torch.train.state import make_optimizer, make_train_step
from tests.test_torch_model import SMALL

torch.set_num_threads(1)

ROWS = (17, 129, 268)
WIDTHS = [(K, N) for K in (512, 1024) for N in (512, 1024, 1536)]


def _rel(got, want):
    return ((got.double() - want).abs().max() / want.abs().max()).item()


def _operands(M, K, N, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    w = torch.randn(N, K, generator=g) * 0.02  # the init's std
    b = torch.randn(N, generator=g) * 0.02
    dy = torch.randn(M, N, generator=g) * 1e-3
    return x, w, b, dy


@pytest.mark.parametrize("K, N", WIDTHS, ids=[f"K{k}-N{n}" for k, n in WIDTHS])
@pytest.mark.parametrize("M", ROWS)
def test_function_matches_f_linear(M, K, N):
    """Forward and input gradient within the larger of 4x F.linear's own
    fp32 error from float64 and 2e-6 of the largest output (the tf32x3
    scheme's band, tests/test_torch_tf32x3.py); the weight and bias
    gradients, plain products on both sides, equal to F.linear's within
    fp32 summation order."""
    x, w, b, dy = _operands(M, K, N, M + K + N)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    ws = [w.clone().requires_grad_() for _ in range(2)]
    bs = [b.clone().requires_grad_() for _ in range(2)]
    y = L.LinearTF32x3.apply(xs[0], ws[0], bs[0])
    y_ref = F.linear(xs[1], ws[1], bs[1])
    y.backward(dy)
    y_ref.backward(dy)

    want_y = x.double() @ w.double().t() + b.double()
    want_dx = dy.double() @ w.double()
    for got, ref, want in ((y.detach(), y_ref.detach(), want_y), (xs[0].grad, xs[1].grad, want_dx)):
        assert _rel(got, want) <= max(4 * _rel(ref, want), 2e-6), (_rel(got, want), _rel(ref, want))
    torch.testing.assert_close(ws[0].grad, ws[1].grad, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(bs[0].grad, bs[1].grad, rtol=1e-5, atol=1e-7)


def test_function_takes_leading_axes_and_no_bias():
    """(R, N, K) tokens as the blocks pass them, no bias (the tp partial
    products): the output keeps the leading axes, no bias gradient."""
    x, w, _, dy = _operands(3 * 17, 512, 512, 1)
    x3 = x.view(3, 17, 512).requires_grad_()
    y = L.LinearTF32x3.apply(x3, w, None)
    assert y.shape == (3, 17, 512)
    y.backward(dy.view(3, 17, 512))
    want = dy.double() @ w.double()
    assert _rel(x3.grad.view(-1, 512), want) <= 2e-6
    torch.testing.assert_close(y.view(-1, 512), F.linear(x, w), rtol=0, atol=2e-6)


@pytest.mark.parametrize("K", [512, 1024, 1536])
def test_gemm_plain_promotes_each_32k_stage(K):
    """`gemm_plain` adds each 32-k stage's lo hi + hi lo + hi hi to the
    result apart, from hi and lo splits of both operands: equal, bit for
    bit, to that sum written out stage by stage."""
    x, w, _, _ = _operands(64, K, 128, K)
    p, _ = L.split_planes_plain(w)
    got = L.gemm_plain(x, p)
    xh = tf32.round_tf32(x)
    xl = tf32.round_tf32(x - xh)
    want = torch.zeros(64, 128)
    for k in range(0, K, 32):
        s = slice(k, k + 32)
        stage = xl[:, s] @ p[0][:, s].t() + xh[:, s] @ p[1][:, s].t() + xh[:, s] @ p[0][:, s].t()
        want = want + stage
    assert torch.equal(got, want)


def test_split_planes_plain_are_the_tf32_planes():
    """Both orientations' planes are `ops.tf32.planes`' (which takes the
    (in, out) layout): w (N, K)'s own for the forward, w^T's for the input
    gradient."""
    _, w, _, _ = _operands(1, 512, 1536, 3)
    p, pt = L.split_planes_plain(w, transposed=True)
    assert torch.equal(p, tf32.planes(w.t())) and torch.equal(pt, tf32.planes(w))
    assert L.split_planes_plain(w)[1] is None


def _fake(shape, dtype=torch.float32, cuda=True):
    """What `routes` reads of a tensor, for a card this machine lacks."""
    return types.SimpleNamespace(shape=shape, dtype=dtype, is_cuda=cuda,
                                 dim=lambda: len(shape))


@pytest.mark.parametrize("case, x, w, want", [
    ("fp32 card qkv", (16524, 512), (1536, 512), True),
    ("fp32 card fc2", (16524, 1024), (512, 1024), True),
    ("fp32 card tp proj share", (16524, 256), (512, 256), True),
    ("bf16", (16524, 512), (1536, 512), False),
    ("cpu", (16524, 512), (1536, 512), False),
    ("embedding K=5", (16524, 5), (512, 5), False),
    ("head N=3", (16524, 512), (3, 512), False),
    ("K % 32", (16524, 500), (512, 500), False),
    ("N % 128", (16524, 512), (500, 512), False),
])
def test_routing_predicate(case, x, w, want):
    dtype = torch.bfloat16 if case == "bf16" else torch.float32
    cuda = case != "cpu"
    assert L.routes(_fake(x, dtype, cuda), _fake(w, dtype, cuda)) is want


def test_linear_stays_on_f_linear_on_the_cpu(monkeypatch):
    """On the CPU `linear` is F.linear itself, bit for bit, and never the
    Function."""
    monkeypatch.setattr(L.LinearTF32x3, "apply", None)
    x, w, b, _ = _operands(129, 512, 1536, 4)
    assert torch.equal(L.linear(x, w, b), F.linear(x, w, b))
    assert L.gemm.launches == 0 and L.split_planes.launches == 0


def _losses(steps=3):
    td = D3DP(D3DPConfig(model=MixSTEConfig(**dict(SMALL, drop_path_rate=0.1))), device="cpu",
              seed=3)
    step = make_train_step(td, make_optimizer(td.model.parameters(), 1e-3))
    r = np.random.RandomState(7)
    g = torch.Generator().manual_seed(11)
    out = []
    for _ in range(steps):
        x2d = (r.randn(2, 9, 17, 2) * 0.3).astype(np.float32)
        x3d = (r.randn(2, 9, 17, 3) * 0.3).astype(np.float32)
        out.append(step(x2d, x3d, np.ones(2, np.float32), generator=g))
    return torch.stack(out)


def test_composed_cpu_train_step_is_unchanged(monkeypatch):
    """The composed CPU train step (DropPath, AdamW) gives the losses of the
    block linears written as F.linear calls, as they were before
    `ops.linear`, bit for bit; `linear` saw every block linear (4 a block, 2
    x depth blocks a step) and routed none."""
    seen = []
    routes = L.routes

    def spy(x, w):
        seen.append(routes(x, w))
        return seen[-1]
    monkeypatch.setattr(L, "routes", spy)
    got = _losses()
    assert len(seen) == 3 * 4 * 2 * SMALL["depth"] and not any(seen)
    monkeypatch.undo()

    def f_linear(lin, x):
        return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))
    row_parallel = mixste._row_parallel
    monkeypatch.setattr(mixste, "_linear", f_linear)
    monkeypatch.setattr(mixste, "_row_parallel",
                        lambda x, w, b, group, product=None: row_parallel(x, w, b, group,
                                                                          product=F.linear))
    assert torch.equal(got, _losses())

"""d3dp_tpu_torch ops against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain torch versions; those are
held against the JAX kernels run in interpret mode. fp32: atol 2e-5
(summation order only; the JAX MLP kernel's erf polynomial is within
1.5e-7 of erf). bf16: both round at the same places, so only a rounding
flipped by summation order separates them -- the card tests' tolerance,
3e-2 plus one bf16 ulp of the value. The kernel-vs-plain tests need the
card and skip here.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from d3dp_tpu.ops.attention import _attention_stage_fwd
from d3dp_tpu.ops.mlp import _mlp_block_t_fwd
from d3dp_tpu_torch.ops import attention as tattn
from d3dp_tpu_torch.ops import mlp as tmlp
from tests.test_torch_kernels import _excess, _mlp_inputs, _stage_inputs, _t

torch.set_num_threads(1)

ATOL = 2e-5
DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_args(arrs, dtype):
    """Same values as `_t(arrs, dtype=...)`: matrices and activations in the
    compute dtype, vectors fp32."""
    return [jnp.asarray(a).astype(dtype) if a.ndim > 1 else jnp.asarray(a) for a in arrs]


def _assert_close(got, want, dtype):
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
    else:
        assert _excess(got, want, dtype) <= 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [17, 27])
def test_attention_stage_plain_matches_jax(rng, N, dtype):
    R, C, h = 4, 64, 8
    args = _stage_inputs(rng, R, N, C)
    want = _attention_stage_fwd(*_jax_args(args, DTYPES[dtype]), h, (C // h) ** -0.5,
                                1e-6, interpret=True, tb=2)
    got = tattn.attention_stage_plain(*_t(args, dtype=dtype), h, (C // h) ** -0.5, 1e-6)
    for g, w in zip(got, want):
        _assert_close(g, w, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 150, 5), (2, 5, 150), (2, 27, 17)])
def test_mlp_block_t_plain_matches_jax(rng, shape, dtype):
    """Both orientations; 150 frames leave a partial last 128-frame tile on
    the JAX side."""
    C, H = 64, 128
    args = _mlp_inputs(rng, *shape, C, H)
    want = _mlp_block_t_fwd(*_jax_args(args, DTYPES[dtype]), 1e-6, interpret=True, tile=128)
    got = tmlp.mlp_block_t_plain(*_t(args, dtype=dtype), 1e-6)
    assert tuple(got.shape) == (shape[0], shape[2], shape[1], C)
    _assert_close(got, want, dtype)


def test_cpu_wrappers_run_plain_and_count_no_launch(rng):
    """On CPU tensors the wrappers are their plain versions, bit for bit,
    and no kernel launch is counted."""
    n_attn, n_mlp = tattn.attention_stage.launches, tmlp.mlp_block_t.launches
    sargs = _t(_stage_inputs(rng, 3, 9, 64))
    for a, b in zip(tattn.attention_stage(*sargs, 8, 0.125, 1e-6),
                    tattn.attention_stage_plain(*sargs, 8, 0.125, 1e-6)):
        assert torch.equal(a, b)
    margs = _t(_mlp_inputs(rng, 2, 9, 17, 64, 128))
    assert torch.equal(tmlp.mlp_block_t(*margs, 1e-6), tmlp.mlp_block_t_plain(*margs, 1e-6))
    assert tattn.attention_stage.launches == n_attn
    assert tmlp.mlp_block_t.launches == n_mlp


@pytest.mark.parametrize("dtype,C,H,ok", [
    (torch.bfloat16, 512, 1024, True), (torch.bfloat16, 128, 128, True),
    (torch.bfloat16, 384, 1152, True), (torch.bfloat16, 640, 1280, False),
    (torch.bfloat16, 192, 384, False), (torch.bfloat16, 512, 1088, False),
    (torch.float32, 512, 1024, True), (torch.float32, 192, 448, False),
    (torch.float32, 1088, 64, False)])
def test_mlp_kernel_shape_rule(dtype, C, H, ok):
    """The shapes the MLP kernels take, checked before a launch: the walks'
    output blocks of 128 columns (C / 2 a warpgroup, at most 256) and hidden
    chunks of 128, in bf16 and fp32."""
    if ok:
        tmlp.check_shape("mlp", C, H, dtype)
    else:
        with pytest.raises(ValueError, match=f"C={C}, H={H}"):
            tmlp.check_shape("mlp", C, H, dtype)


@pytest.mark.parametrize("dtype,C,ok", [
    (torch.bfloat16, 512, True), (torch.bfloat16, 128, True), (torch.bfloat16, 384, True),
    (torch.bfloat16, 640, False), (torch.bfloat16, 192, False), (torch.bfloat16, 64, False),
    (torch.float32, 64, False), (torch.float32, 1024, False), (torch.float32, 1088, False),
    (torch.float32, 384, True)])
def test_stage_kernel_shape_rule(dtype, C, ok):
    """The widths the stage kernels (K1, K1-dp, K8, K6) take, checked before
    a launch: the GEMM walks' C / 2 output columns a warpgroup in 64-column
    blocks, at most 512, in bf16 and fp32."""
    if ok:
        tattn.check_stage_shape("stage", C, dtype)
    else:
        with pytest.raises(ValueError, match=f"C={C}"):
            tattn.check_stage_shape("stage", C, dtype)

"""The arithmetic of K4's fp32 body (the attention backward,
`csrc/attention_qkv.cu`, "backward, fp32 (tf32x3)"), emulated in plain
torch and numpy, since no CUDA runs here.

The body forms every product in three TF32 passes (tf32x3, as
tests/test_torch_tf32x3.py emulates them): S = Q K^T and dP = dO V^T,
dQ = dS K, dK = dS^T Q, dV = P^T dO. Above 32 keys a query pass takes the
softmax statistics online over groups of 32 keys (the row max m; l and
D' = rowsum(dP o e) of e = exp(s - m), rescaled by exp(m_old - m) as m
grows; D = D' / l), then P = exp(s - m) * (1 / l) and dS = P o (dP - D) *
scale; a key pass forms P^T and dS^T from those statistics with the same
operations on the same logits. At 32 keys or fewer the softmax is exact
over the row (D = rowsum(dP o P)). The emulation follows that order and is
held

  * against float64: its error is at most the larger of 4x the plain fp32
    backward's and 2e-6 (relative to the output's largest magnitude), the
    bound the forward products were held to;
  * against JAX's `_fused_attention_qkv_bwd` (Precision.HIGHEST, the Pallas
    kernel in interpret mode): the fp32 parity 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3dp_tpu.ops.attention import _fused_attention_qkv_bwd
from d3dp_tpu_torch.ops import attention as tattn
from tests.test_torch_tf32x3 import tf32x3

torch.set_num_threads(1)

HEADS, C, SCALE = 2, 128, 0.125
GROUP = 32  # keys a group of the query pass's online statistics


def _x3(a, b):
    """a (..., M, K) @ b (..., K, N) in tf32x3, float32, batch by batch."""
    out = np.empty(a.shape[:-1] + b.shape[-1:], np.float32)
    for i in np.ndindex(a.shape[:-2]):
        out[i] = tf32x3(np.ascontiguousarray(a[i]), np.ascontiguousarray(b[i]))
    return out


def _heads(x, parts):
    """(R, N, parts * C) -> parts arrays (R, heads, N, 64)."""
    R, N, _ = x.shape
    return x.reshape(R, N, parts, HEADS, C // HEADS).transpose(2, 0, 3, 1, 4)


def k4_tf32x3(qkv, dout):
    """d(qkv) (R, N, 3C) as the fp32 body computes it, float32."""
    R, N, _ = qkv.shape
    q, k, v = _heads(qkv, 3)
    (do,) = _heads(dout, 1)
    sc = np.float32(SCALE)
    x = _x3(q, k.swapaxes(-1, -2)) * sc  # the logits, rounded before the subtraction
    dp = _x3(do, v.swapaxes(-1, -2))
    if N <= GROUP:
        m = x.max(-1, keepdims=True)
        e = np.exp(x - m)
        inv = np.float32(1) / e.sum(-1, keepdims=True)
        p = e * inv
        D = (dp * p).sum(-1, keepdims=True)
    else:
        m = np.full(x.shape[:-1] + (1,), -np.inf, np.float32)
        l = np.zeros_like(m)
        D = np.zeros_like(m)
        for k0 in range(0, N, GROUP):
            xg, dpg = x[..., k0:k0 + GROUP], dp[..., k0:k0 + GROUP]
            mn = np.maximum(m, xg.max(-1, keepdims=True))
            alpha = np.exp(m - mn)  # 0 at the first group
            m, l, D = mn, l * alpha, D * alpha
            e = np.exp(xg - m)
            l = l + e.sum(-1, keepdims=True)
            D = D + (dpg * e).sum(-1, keepdims=True)
        inv = np.float32(1) / l
        D = D * inv
        p = np.exp(x - m) * inv
    ds = p * (dp - D) * sc
    dq = _x3(ds, k)
    dk = _x3(ds.swapaxes(-1, -2), q)
    dv = _x3(p.swapaxes(-1, -2), do)
    return np.concatenate([t.transpose(0, 2, 1, 3).reshape(R, N, C) for t in (dq, dk, dv)], -1)


def _k4_float64(qkv, dout):
    """d(qkv) in float64 (the JAX kernel's order, every step exact to
    float64)."""
    R, N, _ = qkv.shape
    q, k, v = (t.astype(np.float64) for t in _heads(qkv, 3))
    (do,) = (t.astype(np.float64) for t in _heads(dout, 1))
    s = q @ k.swapaxes(-1, -2) * SCALE
    e = np.exp(s - s.max(-1, keepdims=True))
    p = e / e.sum(-1, keepdims=True)
    dp = do @ v.swapaxes(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdims=True)) * SCALE
    grads = (ds @ k, ds.swapaxes(-1, -2) @ q, p.swapaxes(-1, -2) @ do)
    return np.concatenate([t.transpose(0, 2, 1, 3).reshape(R, N, C) for t in grads], -1)


def _inputs(N, R=2):
    rng = np.random.RandomState(N)
    return (rng.randn(R, N, 3 * C).astype(np.float32),
            rng.randn(R, N, C).astype(np.float32))


def _rel(got, want):
    return np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()


# the spatial stages' 17 keys (the exact softmax), one key past a group, and
# the temporal 243 (eight groups, the last of 19 keys)
NS = [17, 33, 243]


@pytest.mark.parametrize("N", NS)
def test_k4_tf32x3_error_against_float64(N):
    qkv, dout = _inputs(N)
    want = _k4_float64(qkv, dout)
    err_x3 = _rel(k4_tf32x3(qkv, dout), want)
    err_f32 = _rel(tattn.fused_attention_qkv_bwd_plain(
        torch.from_numpy(qkv), torch.from_numpy(dout), HEADS, SCALE).numpy(), want)
    assert err_x3 <= max(4 * err_f32, 2e-6), (err_x3, err_f32)


@pytest.mark.parametrize("N", NS)
def test_k4_tf32x3_matches_jax_highest(N):
    qkv, dout = _inputs(N)
    want = np.asarray(_fused_attention_qkv_bwd(jnp.asarray(qkv), jnp.asarray(dout), HEADS, SCALE,
                                               interpret=True))
    np.testing.assert_allclose(k4_tf32x3(qkv, dout), want, atol=2e-5, rtol=0)

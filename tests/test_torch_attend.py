"""The attention stage's attention phase alone (`attend_qkv`, K1's attend
launch) against the JAX package's attention core.

On the CPU `attend_qkv` runs its plain version, `attend_qkv_plain`: the
stage's order, P.V on the unnormalised bf16 p with 1/l folded into the
output, or with p / l rounded first under OPT_NORM_FIRST, the order of the
JAX attention core (`fused_attention_qkv`, `_attn_head`) run here in
interpret mode. fp32 divides first in both: summation order only, 2e-5.
bf16 with p / l first rounds where the JAX core rounds: one bf16 ulp of the
value plus 1e-3, as the core's own parity test. bf16 in the stage's order
rounds p before its division: the card tests' band for the attention core,
1e-2 plus one ulp (outputs of about 0.1). The kernel against this plain
version needs the card (tests/test_torch_kernels.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from d3dp_tpu.ops.attention import fused_attention_qkv
from d3dp_tpu_torch.ops import attention as tattn

torch.set_num_threads(1)

DTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _bf16_ulp(x):
    """One bf16 ulp of |x| (8 significant bits)."""
    return 2.0 ** (np.frexp(np.abs(x))[1] - 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("opts", [0, tattn.OPT_NORM_FIRST])
@pytest.mark.parametrize("R,N", [(8, 17), (3, 65), (2, 243), (5, 1), (4, 2), (3, 31),
                                 (3, 32)])
def test_attend_qkv_plain_matches_jax_attention_core(rng, R, N, opts, dtype):
    qkv = rng.randn(R, N, 3 * 512).astype(np.float32)
    want = np.asarray(fused_attention_qkv(jnp.asarray(qkv).astype(DTYPES[dtype]), 8, 0.125,
                                          interpret=True).astype(jnp.float32))
    got = tattn.attend_qkv_plain(torch.from_numpy(qkv).to(dtype), 8, 0.125, opts)
    assert got.dtype == dtype and tuple(got.shape) == (R, N, 512)
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    elif opts == tattn.OPT_NORM_FIRST:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-3)
    else:
        assert np.all(np.abs(got - want) <= _bf16_ulp(want) + 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attend_qkv_plain_with_p_over_l_first_is_the_attention_core(rng, dtype):
    """Under OPT_NORM_FIRST (and in fp32 always) the stage's attention is the
    attention core's plain version bit for bit: K3 launches that tile."""
    qkv = torch.from_numpy(rng.randn(4, 33, 3 * 128).astype(np.float32)).to(dtype)
    core = tattn.fused_attention_qkv_plain(qkv, 2, 0.3)
    assert torch.equal(tattn.attend_qkv_plain(qkv, 2, 0.3, tattn.OPT_NORM_FIRST), core)
    assert torch.equal(tattn.attend_qkv_plain(qkv, 2, 0.3), core) == (dtype == torch.float32)


def test_cpu_attend_qkv_runs_plain_and_counts_no_launch(rng):
    n0 = tattn.attend_qkv.launches
    qkv = torch.from_numpy(rng.randn(3, 40, 192).astype(np.float32)).to(torch.bfloat16)
    for opts in (0, tattn.OPT_NORM_FIRST, tattn.OPT_BF16_EXP):
        assert torch.equal(tattn.attend_qkv(qkv, 1, 0.125, opts),
                           tattn.attend_qkv_plain(qkv, 1, 0.125, opts))
    assert tattn.attend_qkv.launches == n0

"""The port's training data path and light validation against the JAX
package's, on the CPU: `ChunkedGenerator` batch for batch and bit for bit
(against the JAX generator's Python extraction path, `use_native=False`),
its random-state round trip and endless resume, and `Evaluator(light=True)`
(P-Best only, training's end-of-epoch validation) with replayed noise within
3.1e-4 mm, the whole-pipeline tolerance."""

import copy

import jax
import numpy as np
import pytest
import torch

from d3dp_tpu.data import synthetic as jsyn
from d3dp_tpu.data.generators import ChunkedGenerator as JChunked
from d3dp_tpu.data.generators import UnchunkedGenerator as JGen
from d3dp_tpu.diffusion import D3DP as JD3DP, D3DPConfig as JD3DPConfig
from d3dp_tpu.eval import Evaluator as JEvaluator
from d3dp_tpu.models import MixSTEConfig as JMixSTEConfig
from d3dp_tpu_torch.data.generators import ChunkedGenerator, UnchunkedGenerator
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.eval import Evaluator
from d3dp_tpu_torch.models import MixSTEConfig
from tests.test_torch_model import port_model, random_params
from tests.test_torch_pipeline import CFG, GEN_LR, LR, _provider

torch.set_num_threads(1)


# ------------------------------------------------------------ generator
def _gen_kw(**kw):
    return dict(chunk_length=27, shuffle=True, random_seed=1234, augment=True, pad_last=True,
                **GEN_LR, **kw)


def _epoch(gen, n=None):
    out = []
    for i, batch in enumerate(gen.next_epoch()):
        if n is not None and i == n:
            break
        out.append(batch)
    return out


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        assert len(ba) == len(bb)
        for x, y in zip(ba, bb):
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("pad_last", [True, False])
def test_chunked_generator_matches_jax(pad_last):
    data = jsyn.make_dataset(seed=2, lengths=(100, 80, 30))
    kw = _gen_kw()
    kw["pad_last"] = pad_last
    tg = ChunkedGenerator(4, *data, **kw)
    jg = JChunked(4, *data, **kw, use_native=False)
    assert np.array_equal(tg.chunks, jg.chunks) and tg.num_batches == jg.num_batches
    first = _epoch(tg)
    _assert_same_batches(first, _epoch(jg))
    assert first[-1][-1].min() == 0.0 if pad_last else len(first[-1]) == 3
    # a second epoch reshuffles, the same way in both
    _assert_same_batches(_epoch(tg), _epoch(jg))


def test_chunked_generator_random_state_round_trip():
    data = jsyn.make_dataset(seed=2, lengths=(100, 80, 30))
    tg = ChunkedGenerator(4, *data, **_gen_kw())
    jg = JChunked(4, *data, **_gen_kw(), use_native=False)
    saved_t, saved_j = copy.deepcopy(tg.random_state()), copy.deepcopy(jg.random_state())
    first = _epoch(tg)
    _epoch(jg)
    tg.set_random_state(saved_t)
    jg.set_random_state(saved_j)
    again = _epoch(tg)
    _assert_same_batches(again, first)
    _assert_same_batches(again, _epoch(jg))


def test_chunked_generator_endless_resumes_mid_epoch():
    data = jsyn.make_dataset(seed=2, lengths=(100, 80, 30))
    tg = ChunkedGenerator(4, *data, **_gen_kw(endless=True))
    jg = JChunked(4, *data, **_gen_kw(endless=True), use_native=False)
    n = tg.num_batches
    head_t, head_j = _epoch(tg, 2), _epoch(jg, 2)
    tail_t, tail_j = _epoch(tg, n), _epoch(jg, n)  # the rest, then a new epoch
    _assert_same_batches(head_t + tail_t, head_j + tail_j)
    assert len(tail_t) == n


# ------------------------------------------------------- light validation
def test_light_evaluator_matches_jax():
    jcfg = JMixSTEConfig(**CFG)
    params = random_params(jcfg, seed=4, scale=0.02)
    dkw = dict(num_proposals=2, sampling_timesteps=2, joints_left=tuple(jsyn.JOINTS_LEFT),
               joints_right=tuple(jsyn.JOINTS_RIGHT))
    data = jsyn.make_dataset(seed=1, lengths=(100, 80))
    ekw = dict(receptive_field=CFG["num_frames"], batch_size=4, light=True, **LR)
    jev = JEvaluator(JD3DP(JD3DPConfig(model=jcfg, **dkw)), **ekw)
    want = jev.evaluate({"params": params}, JGen(*data, **GEN_LR), jax.random.PRNGKey(0),
                        noise_provider=_provider()).averages_mm()
    tev = Evaluator(D3DP(D3DPConfig(model=MixSTEConfig(**CFG), **dkw),
                         model=port_model(params, **CFG)), **ekw)
    got = tev.evaluate(UnchunkedGenerator(*data), noise_provider=_provider()).averages_mm()
    assert set(got) == set(want) == {"P_Best"}
    np.testing.assert_allclose(got["P_Best"], want["P_Best"], atol=3.1e-4, rtol=0)
    with pytest.raises(ValueError, match="p2"):
        Evaluator(tev.d3dp, light=True, p2=True)

"""The port's host-side input pipeline and utilities against the JAX
package's, on the CPU: the native (C++) chunk assembler behind
`ChunkedGenerator(use_native=True)`, the Prefetcher that the command lines
run under either `--input-pipeline` value (tests/test_grain_pipeline.py's
checks of the JAX package's grain pipeline: grain imports JAX, so the port
keeps its one pipeline for both), `UnchunkedGeneratorSeq2Seq`, the skeleton
adjacency helpers and the tile-generation advisory. Batches are compared
byte for byte; the adjacency matrices exactly.
"""

import pickle
import threading
import warnings

import numpy as np
import pytest
import torch

from d3dp_tpu.data import generators as jgen
from d3dp_tpu.data.h36m import h36m_skeleton as j_h36m_skeleton
from d3dp_tpu.utils import graph as jgraph
from d3dp_tpu_torch.data import generators as tgen
from d3dp_tpu_torch.data import native
from d3dp_tpu_torch.data.h36m import h36m_skeleton
from d3dp_tpu_torch.data.prefetch import Prefetcher
from d3dp_tpu_torch.ops import tuning
from d3dp_tpu_torch.parallel import mesh as tmesh
from d3dp_tpu_torch.utils import graph as tgraph

KL, KR = [4, 5, 6], [1, 2, 3]


def _data(seed=0):
    rng = np.random.RandomState(seed)
    p3 = [rng.randn(n, 17, 3).astype(np.float32) for n in (40, 55, 23)]
    p2 = [rng.randn(n, 17, 2).astype(np.float32) for n in (40, 55, 23)]
    cams = [rng.randn(9).astype(np.float32) for _ in range(3)]
    return cams, p3, p2


def make_gen(module, use_native, seed=1234, **kw):
    """A shuffled, flip-augmented, pad_last generator of 9-frame chunks
    over three sequences (tests/test_grain_pipeline.py's)."""
    return module.ChunkedGenerator(4, *_data(), 9, shuffle=True, random_seed=seed, augment=True,
                                   kps_left=KL, kps_right=KR, joints_left=KL, joints_right=KR,
                                   pad_last=True, use_native=use_native, **kw)


def _assert_epochs_equal(a, b):
    assert len(a) == len(b) and len(a) > 1
    for ba, bb in zip(a, b):
        assert len(ba) == len(bb) == 4
        for xa, xb in zip(ba, bb):
            xa, xb = np.asarray(xa), np.asarray(xb)
            assert xa.dtype == xb.dtype and xa.shape == xb.shape
            assert xa.tobytes() == xb.tobytes()


# ------------------------------------------------------- native assembler
def test_native_assembler_is_the_ports_own_build():
    """It builds here (g++), into the port's build directory, never the JAX
    package's native/libchunk_assembler.so."""
    assert native.available()
    path = native._lib_path()
    assert path.exists() and path.parent.parent == native.BUILD_ROOT
    assert "d3dp_tpu_torch" in str(path) and path.name == "libchunk_assembler.so"


def test_native_batches_are_byte_identical_to_numpy_and_jax():
    """Two epochs: the port's native path, its numpy path and the JAX
    package's native path give the same bytes, and each generator records
    the path it took."""
    nat, npy = make_gen(tgen, True), make_gen(tgen, False)
    jax_nat = make_gen(jgen, True)
    assert nat.assembler == "native" and npy.assembler == "numpy"
    assert jax_nat._native is not None
    for _ in range(2):
        a = list(nat.next_epoch())
        _assert_epochs_equal(a, list(npy.next_epoch()))
        _assert_epochs_equal(a, list(jax_nat.next_epoch()))


def test_native_chunks_edge_pad_and_flip(rng):
    """assemble_chunks directly: windows overhanging both sequence edges,
    flipped and not, against the numpy extraction."""
    seqs = [rng.randn(n, 5, 3).astype(np.float32) for n in (4, 11)]
    bank = native.SequenceBank(seqs)
    chunks = np.array([[0, -3, 6, 0], [1, 7, 16, 1], [1, -2, 7, 1], [0, 0, 9, 0]], np.int64)
    perm = np.array([0, 3, 4, 1, 2], np.int32)
    sign = np.array([-1, 1, 1], np.float32)
    got = native.assemble_chunks(bank, chunks, 9, perm, sign)
    for out, (s, start, end, flip) in zip(got, chunks):
        idx = np.clip(np.arange(start, end), 0, len(seqs[s]) - 1)
        want = seqs[s][idx]
        if flip:
            want = tgen.flip_sequence(want, [1, 2], [3, 4])
        assert out.tobytes() == want.astype(np.float32).tobytes()
    with pytest.raises(ValueError, match="not \\(T, 5, 3\\)"):
        native.SequenceBank([seqs[0], rng.randn(3, 4, 3)])


def test_numpy_path_without_a_toolchain(monkeypatch):
    """Where the assembler cannot be built the generator takes the numpy
    path, with the same batches, and says so."""
    monkeypatch.setattr(native, "available", lambda: False)
    gen = make_gen(tgen, True)
    assert gen.assembler == "numpy"
    _assert_epochs_equal(list(gen.next_epoch()), list(make_gen(tgen, False).next_epoch()))


# ---------------------- the training pipeline, under either --input-pipeline
def _epoch(gen, to_device=None):
    """One epoch as the command lines read it under either
    `--input-pipeline` value: the generator's epoch through the Prefetcher."""
    return Prefetcher(gen.next_epoch(), to_device=to_device, depth=2)


@pytest.mark.parametrize("use_native", [True, False])
def test_byte_identical_epochs(use_native):
    """Two epochs through the Prefetcher equal next_epoch's, the shuffle in
    lockstep (tests/test_grain_pipeline.py:27's check of the JAX package's
    grain pipeline)."""
    plain, fed = make_gen(tgen, use_native), make_gen(tgen, use_native)
    for _ in range(2):
        _assert_epochs_equal(list(plain.next_epoch()), list(_epoch(fed)))
    assert fed.num_frames() == plain.num_frames() == plain.num_batches * 4


def test_rng_resume_contract():
    """A pickled copy of the RandomState after an epoch through the
    Prefetcher (whose worker reads ahead) resumes the same next epoch
    (tests/test_grain_pipeline.py:40)."""
    g1 = make_gen(tgen, True)
    list(_epoch(g1))
    state = pickle.loads(pickle.dumps(g1.random_state()))
    g2 = make_gen(tgen, True)
    g2.set_random_state(state)
    _assert_epochs_equal(list(_epoch(g1)), list(_epoch(g2)))


def test_pipeline_with_sharded_to_device():
    """The Prefetcher composes with the command line's to_device under a
    mesh (tests/test_grain_pipeline.py:57): rank 0 of dp=2 gets its rows of
    each batch padded to the dp quantum, as tensors, the weights global."""
    mesh = tmesh.Mesh(2, 1, 0, (torch.device("cpu"),) * 2)
    cams, p3, p2 = _data(1)

    def gen():
        return tgen.ChunkedGenerator(5, cams, p3, p2, 27, shuffle=True, augment=True,
                                     kps_left=KL, kps_right=KR, joints_left=KL,
                                     joints_right=KR, pad_last=True)

    sharded = list(_epoch(gen(), to_device=tmesh.shard_batch_fn(mesh)))
    plain = list(gen().next_epoch())
    assert len(sharded) == len(plain) > 1
    for (_, b3s, b2s, ws), (_, b3p, b2p, wp) in zip(sharded, plain):
        assert isinstance(b3s, torch.Tensor) and b3s.shape[0] == 3  # 5 rows padded to 6
        np.testing.assert_array_equal(b3s.numpy(), b3p[:3])
        np.testing.assert_array_equal(b2s.numpy(), b2p[:3])
        assert ws.shape == (6,) and ws.sum() == wp.sum()


def test_early_stop():
    """A consumer that stops after one batch gets next_epoch's first batch
    and leaves no worker thread behind."""
    before = threading.active_count()
    it = iter(_epoch(make_gen(tgen, True)))
    first = next(it)
    it.close()
    assert threading.active_count() == before
    for x, y in zip(first, next(make_gen(tgen, True).next_epoch())):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


# ----------------------------------------------------------- the utilities
@pytest.mark.parametrize("augment,pad,causal_shift", [(False, 0, 0), (True, 4, 0), (True, 6, 2)])
def test_unchunked_seq2seq_matches_jax(augment, pad, causal_shift):
    """Every yield of UnchunkedGeneratorSeq2Seq equals the JAX package's,
    with and without cameras and 3D poses."""
    cams, p3, p2 = _data(2)
    for args in ((cams, p3, p2), (None, None, p2)):
        kw = dict(pad=pad, causal_shift=causal_shift, augment=augment, kps_left=KL,
                  kps_right=KR, joints_left=KL, joints_right=KR)
        got = list(tgen.UnchunkedGeneratorSeq2Seq(*args, **kw).next_epoch())
        want = list(jgen.UnchunkedGeneratorSeq2Seq(*args, **kw).next_epoch())
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert len(g) == len(w) == 3
            for a, b in zip(g, w):
                assert (a is None) == (b is None)
                if a is not None:
                    assert a.dtype == b.dtype and np.array_equal(a, b)
        assert got[0][2].shape == (2 if augment else 1, 40 + 2 * pad, 17, 2)
    gen = tgen.UnchunkedGenerator(cams, p3, p2, 3, 1)
    assert (gen.pad, gen.causal_shift, gen.augment) == (3, 1, False)


def test_adjacency_matches_jax():
    edges = [(0, 1), (1, 2), (2, 3), (1, 4)]
    np.testing.assert_array_equal(tgraph.adj_mx_from_edges(5, edges),
                                  jgraph.adj_mx_from_edges(5, edges))
    got = tgraph.adj_mx_from_skeleton(h36m_skeleton())
    want = jgraph.adj_mx_from_skeleton(j_h36m_skeleton())
    assert got.shape == (32, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, got.T)


def test_tile_advisory_once_off_the_tuned_card(monkeypatch):
    """One warning a process on another card, none on the H100 the tiles
    were measured on."""
    monkeypatch.setattr(tuning, "_checked", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tuning.check_tile_generation("NVIDIA H200")
        tuning.check_tile_generation("NVIDIA H200")
    assert len(caught) == 1 and "NVIDIA H200" in str(caught[0].message)
    monkeypatch.setattr(tuning, "_checked", False)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tuning.check_tile_generation(tuning.TUNED_DEVICE)
    assert caught == []

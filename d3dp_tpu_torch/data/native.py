"""ctypes bindings of the native (C++) batch chunk assembler.

The port's own copy of d3dp_tpu/data/native.py: the same C function
(`native/chunk_assembler.cpp`: chunk extraction with edge padding and the
flip augmentation, x negated and left/right joints swapped, in one pass
over contiguous float32 memory) behind the same `available`,
`SequenceBank` and `assemble_chunks`.

The library is built at first use with `g++ -O3 -march=native` into the
port's build directory, `d3dp_tpu_torch/_build/native-<digest>/`, the
digest covering the source, the flags and the host (an `-march=native`
build runs only on the CPU it was built for). The JAX package's
`native/libchunk_assembler.so` is never read or written. Where no
toolchain is found, `available()` is False and `ChunkedGenerator` takes
its numpy path, as the JAX package's does; the generator records which
path it took (`ChunkedGenerator.assembler`).
"""

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "chunk_assembler.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path():
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(f"{platform.node()} {platform.machine()} {platform.processor()}".encode())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}" / "libchunk_assembler.so"


def _build(path):
    """g++ into a temporary file beside `path`, then renamed over it, so
    another process never loads a half-written library."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, "-o", tmp, str(SOURCE)], check=True, capture_output=True)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = _lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
        except (OSError, subprocess.CalledProcessError):
            return None  # no toolchain: the numpy path
        f32, i64 = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64)
        lib.assemble_chunks.argtypes = [f32, i64, i64, ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64, ctypes.c_int64,
                                        ctypes.POINTER(ctypes.c_int32), f32, f32]
        lib.assemble_chunks.restype = None
        _lib = lib
        return _lib


def available():
    """True where the assembler is built (or builds now) and loads."""
    return _load() is not None


class SequenceBank:
    """Sequences (T_i, J, C) flattened into one contiguous float32 buffer
    with their frame offsets."""

    def __init__(self, sequences):
        self.J, self.C = sequences[0].shape[1:]
        self.offsets = np.zeros(len(sequences) + 1, dtype=np.int64)
        for i, s in enumerate(sequences):
            if s.shape[1:] != (self.J, self.C):
                raise ValueError(f"sequence {i} is {s.shape}, not (T, {self.J}, {self.C})")
            self.offsets[i + 1] = self.offsets[i] + s.shape[0]
        self.data = np.ascontiguousarray(np.concatenate(sequences, axis=0), dtype=np.float32)


def assemble_chunks(bank, chunks, chunk_len, perm, flip_sign, out=None):
    """Chunks int64 (n, 4) of (seq_idx, start, end, flip) from `bank` ->
    float32 (n, chunk_len, J, C): frames outside a sequence edge-padded, a
    flipped chunk's joints permuted by `perm` (int32 (J,)) and its channels
    multiplied by `flip_sign` (float32 (C,)). Writes into `out` where given
    (C-contiguous)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("the native chunk assembler is not available (no g++)")
    chunks = np.ascontiguousarray(chunks, dtype=np.int64)
    n = chunks.shape[0]
    if out is None:
        out = np.empty((n, chunk_len, bank.J, bank.C), dtype=np.float32)
    if out.shape != (n, chunk_len, bank.J, bank.C) or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous {(n, chunk_len, bank.J, bank.C)}")
    perm = np.ascontiguousarray(perm, dtype=np.int32)
    flip_sign = np.ascontiguousarray(flip_sign, dtype=np.float32)

    def ptr(a, ct):
        return a.ctypes.data_as(ctypes.POINTER(ct))

    lib.assemble_chunks(ptr(bank.data, ctypes.c_float), ptr(bank.offsets, ctypes.c_int64),
                        ptr(chunks, ctypes.c_int64), n, chunk_len, bank.J, bank.C,
                        ptr(perm, ctypes.c_int32), ptr(flip_sign, ctypes.c_float),
                        ptr(out, ctypes.c_float))
    return out

"""Build and bind the hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into its own shared library with a
plain C interface, loaded through `ctypes` (no PyTorch headers, so a build
takes seconds). Libraries are built at first use into
`d3dp_tpu_torch/_build/<digest>/`, where the digest covers every source and
the compiler flags; all sources compile in parallel, one `nvcc` each.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine with no `nvcc`.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

from d3dp_tpu_torch.ops import tuning

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("attention_stage", "attention_block", "attention_qkv", "mlp_block_t", "resident",
           "residual_ln", "linear_tf32x3")
# libraries built from one of the sources with extra flags, on demand only:
# name -> (source, flags)
VARIANTS = {"resident_clocks": ("resident", ("-DD3DP_PHASE_CLOCKS",))}
# -split-compile=0: the device optimizer runs on every core, which shortens the
# build of the depth-resident kernel (every walk inlined, three instantiations)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-split-compile=0", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_libs = {}


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def build_dir():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name):
    return build_dir() / f"lib{name}.so"


def build_all(names=SOURCES):
    """Compile every missing library of `names` (SOURCES or VARIANTS), all
    `nvcc` processes at once.

    Returns the build directory. Each library's compiler output (register
    and spill counts from `-Xptxas=-v`) is kept in `<name>.log` beside it.
    """
    with _lock:
        out = build_dir()
        todo = [n for n in names if not (out / f"lib{n}.so").exists()]
        if not todo:
            return out
        out.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for n in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out)
            os.close(fd)
            log = open(out / f"{n}.log", "w")
            src, flags = VARIANTS.get(n, (n, ()))
            cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", tmp, str(CSRC / f"{src}.cu")]
            procs.append((n, tmp, log,
                          subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for n, tmp, log, p in procs:
            rc = p.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, out / f"lib{n}.so")
            else:
                os.unlink(tmp)
                failed.append(n)
        if failed:
            msgs = "\n".join((out / f"{n}.log").read_text()[-4000:] for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
        return out


def load(name, signatures):
    """ctypes handle of library `name`, building it first if needed.

    signatures: {function name: argtypes list}; every function returns the
    `cudaError_t` of its launches as an int. The first load is the first
    kernel launch of the process: it checks the card the tiles were tuned
    on (`ops.tuning.check_tile_generation`).
    """
    lib = _libs.get(name)
    if lib is None:
        tuning.check_tile_generation()
        build_all((name,) if name in VARIANTS else SOURCES)
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return lib


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(text):
    """[{kernel, registers, stack, spill_stores, spill_loads}] of each entry
    function in one library's `-Xptxas=-v` output (`<name>.log`); kernel is
    the mangled name. The spill line counted is the one under the entry's
    own "Function properties" (a called function has its own)."""
    out, cur, props = [], None, None
    for line in text.splitlines():
        if m := _ENTRY.search(line):
            cur = {"kernel": m.group(1)}
            out.append(cur)
        elif m := _PROPS.search(line):
            props = m.group(1)
        elif cur is not None and props == cur["kernel"] and (m := _SPILL.search(line)):
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif cur is not None and (m := _REGS.search(line)):
            cur["registers"] = int(m.group(1))
    return out


def demangle(names):
    """The C++ names of mangled symbols (`c++filt`), or the names as they
    are where the tool is missing."""
    tool = shutil.which("c++filt")
    if not tool or not names:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else list(names)


# the launchers' own codes beside cudaError_t (kNoTensorMap in csrc/mlp.cuh)
_OWN_ERRORS = {-3: "cuTensorMapEncodeTiled is unavailable or refused a weight map"}


def check(err, what):
    if err != 0:
        raise RuntimeError(f"{what}: {_OWN_ERRORS.get(err, f'CUDA error {err}')}")


def check_operand(t, name, dtype, shape, device):
    """Raise unless `t` is what a kernel takes: device, dtype, shape, and a
    contiguous 16-byte-aligned buffer (the kernels load 16-byte vectors)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")

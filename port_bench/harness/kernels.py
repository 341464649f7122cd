"""Device operations of a trace by the function they run."""

import re
from pathlib import Path

_NAME = re.compile(r"(?:void\s+)?(?:[\w]+::|\(anonymous namespace\)::)*(\w+)")
_GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(")


def function(name):
    """The function of a device operation's name ("void f<...>(...)" -> "f")."""
    m = _NAME.match(name)
    return m.group(1) if m else name


def by_prefix(ops, prefixes):
    """{prefix: [seconds of each operation whose function starts with it]}."""
    out = {p: [] for p in prefixes}
    for name, a, b in ops:
        f = function(name)
        for p in prefixes:
            if f.startswith(p):
                out[p].append((b - a) / 1e9)
                break
    return out


def port_kernels(repo):
    """The names of every __global__ function of the port's CUDA sources."""
    names = set()
    for f in sorted((Path(repo) / "d3dp_tpu_torch" / "ops" / "csrc").glob("*.cu*")):
        names.update(_GLOBAL.findall(f.read_text()))
    return names

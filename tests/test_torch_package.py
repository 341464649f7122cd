"""d3dp_tpu_torch package rules: no JAX and no d3dp_tpu anywhere in it, and
no silent CPU fallback for the entry points."""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import d3dp_tpu_torch

torch.set_num_threads(1)

PKG = Path(d3dp_tpu_torch.__file__).resolve().parent
REPO = PKG.parent


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], "d3dp_tpu_torch."))


def test_import_leaves_jax_and_reference_out():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'd3dp_tpu', 'grain')]\n"
        "assert not bad, bad\n"
        "print('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|d3dp_tpu|grain)(\.|\s|$)", re.M)
    files = list(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, (f, hits)


def test_package_mirrors_layout():
    for m in ("device", "diffusion.schedule", "diffusion.d3dp", "geometry.camera",
              "geometry.quaternion", "ops.attention", "ops.mlp", "models.mixste",
              "train.convert", "train.state", "metrics.mpjpe", "metrics.procrustes_np",
              "data.windowing", "data.prefetch", "data.generators", "data.synthetic",
              "data.skeleton", "data.mocap", "data.h36m", "eval.evaluator",
              "train.checkpoint_io", "cli.arguments", "cli.data_prep", "cli.main_h36m",
              "ops.resident", "metrics.procrustes", "metrics.pck_auc", "data.mpi3dhp",
              "eval.aggregation", "eval.evaluator_3dhp", "cli.main_3dhp",
              "viz.visualization", "in_the_wild.inference", "cli.render", "cli.main_draw",
              "cli.main_in_the_wild", "parallel.mesh", "parallel.multihost",
              "parallel.tp", "ops.residual_ln", "utils.misc", "utils.logging",
              "utils.profiling", "data.native", "data.prefetch", "utils.graph",
              "ops.tuning"):
        assert f"d3dp_tpu_torch.{m}" in _modules(), m


def test_every_cuda_source_is_built_and_bound():
    """Each csrc/*.cu is in the build list, and each built library is loaded
    by an ops wrapper, so a new kernel cannot go unbuilt or unused."""
    from d3dp_tpu_torch.ops import _build

    sources = sorted(f.stem for f in (PKG / "ops" / "csrc").glob("*.cu"))
    assert sorted(_build.SOURCES) == sources
    assert {"attention_qkv", "attention_block"} <= set(sources)
    wrappers = "".join(f.read_text() for f in (PKG / "ops").glob("*.py"))
    for name in sources:
        assert f'_build.load("{name}"' in wrappers, name


def test_ptxas_report_reads_each_entry_functions_own_lines():
    """Registers and spills per entry function, from `-Xptxas=-v` output; a
    called (not inlined) function's spill line is not its caller's."""
    from d3dp_tpu_torch.ops import _build

    text = """ptxas info    : Compiling entry function '_Z1av' for 'sm_90a'
ptxas info    : Function properties for _Z1av
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 48 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z1bv' for 'sm_90a'
ptxas info    : Function properties for _Z1bv
    32 bytes stack frame, 28 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 32 bytes cumulative stack size
ptxas info    : Function properties for _Z1cv
    0 bytes stack frame, 48 bytes spill stores, 48 bytes spill loads
"""
    assert _build.ptxas_report(text) == [
        {"kernel": "_Z1av", "stack": 0, "spill_stores": 0, "spill_loads": 0, "registers": 48},
        {"kernel": "_Z1bv", "stack": 32, "spill_stores": 28, "spill_loads": 24,
         "registers": 255}]


def test_train_modules_import_no_jax():
    """The training slice's modules, with the tensor-parallel ones, the host
    pipeline (the native assembler, the Prefetcher of either
    `--input-pipeline`), the checkpoint formats and the graph helpers,
    imported alone, pull in no JAX and no grain."""
    code = (
        "import sys\n"
        "import d3dp_tpu_torch.train.state, d3dp_tpu_torch.ops.attention\n"
        "import d3dp_tpu_torch.data.generators\n"
        "import d3dp_tpu_torch.parallel.tp, d3dp_tpu_torch.ops.residual_ln\n"
        "import d3dp_tpu_torch.data.native, d3dp_tpu_torch.data.prefetch\n"
        "import d3dp_tpu_torch.train.checkpoint_io, d3dp_tpu_torch.utils.graph\n"
        "from d3dp_tpu_torch.ops.attention import fused_attention_qkv_ad\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'd3dp_tpu', 'grain', 'orbax')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_cli_modules_import_no_jax():
    """The command lines, imported alone, pull in no JAX, flax or optax."""
    code = (
        "import sys\n"
        "import d3dp_tpu_torch.cli.main_h36m, d3dp_tpu_torch.cli.main_3dhp\n"
        "import d3dp_tpu_torch.cli.main_draw, d3dp_tpu_torch.cli.main_in_the_wild\n"
        "import d3dp_tpu_torch.in_the_wild.inference\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'd3dp_tpu')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    from d3dp_tpu_torch import resolve_device
    from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
    from d3dp_tpu_torch.models import MixSTE2, MixSTEConfig

    small = MixSTEConfig(num_frames=9, embed_dim=64, depth=1)
    from d3dp_tpu_torch.cli import main_3dhp, main_draw, main_h36m, main_in_the_wild
    from d3dp_tpu_torch.in_the_wild import inference_video

    argv = ["-d", "synthetic", "--nolog", "-cs", "64", "-dep", "1", "-f", "9", "-e", "0"]
    for make in (lambda: resolve_device(), lambda: MixSTE2(small),
                 lambda: D3DP(D3DPConfig(model=small)),
                 lambda: main_h36m.main(argv), lambda: main_3dhp.main(argv),
                 lambda: main_draw.main(argv), lambda: main_in_the_wild.main(argv),
                 lambda: inference_video("video.mp4", "npz", argv=argv[3:])):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
    assert next(MixSTE2(small, device="cpu").parameters()).device.type == "cpu"

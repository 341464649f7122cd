"""What every cell shares: the files a cell is made of, seeds, the weights
and the synthetic poses made from a seed, and the device's description.

Nothing here imports the program at import time: `make_program` and the
loops do, inside their functions.
"""

import hashlib
import json
from pathlib import Path

import numpy as np

from port_bench.arch import architecture
from port_bench.reference.modes import project_to_2d

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def cell_files(workload, benchmark=None):
    """(cell, configuration, traffic, limits) of a cell of BENCHMARK.json,
    each read from its file under the benchmark's folder."""
    bench = benchmark or load_json(REPO / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload named {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(REPO / entry["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(BENCH_DIR / "limits" / f"{workload}.json")
    return bench, cell, config, traffic, limits


def metrics_of(bench, workload, section):
    """The entries of `section` ("end_to_end" or "per_layer") that the
    cell reports: those without a "workloads" list, and those naming it."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def sub_seed(seed, *salt):
    """A 63-bit seed for one use of the run's seed (weights, data, draws)."""
    h = hashlib.sha256(":".join(str(s) for s in (seed, *salt)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


# ------------------------------------------------------------------ program
def make_program(arch, config, device, seed, **sampling):
    """The port's D3DP of the configuration, its denoiser configured by the
    architecture module `arch`, its weights not yet loaded; `sampling` is
    an eval traffic's `sampling_timesteps` and `num_proposals`."""
    from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig

    d = config["diffusion"]
    dcfg = D3DPConfig(model=arch.denoiser_config(config["model"]), timesteps=d["timesteps"],
                      scale=d["scale"], eta=d["eta"], flip_tta=d["flip_tta"],
                      unit_scale=d["unit_scale"], joints_left=tuple(config["joints_left"]),
                      joints_right=tuple(config["joints_right"]), **sampling)
    return D3DP(dcfg, device=device, seed=seed)


# ------------------------------------------------------------------ weights
def make_weights(torch, model_cfg, seed, device):
    """{state_dict key: float32 tensor} of the configuration's architecture
    from the seed, made on `device` in one draw: each parameter its usual
    start (Linear weights N(0, 0.02^2), biases and position embeddings 0,
    LayerNorm scales 1) plus an offset N(0, 0.02^2), so no bias, embedding
    or LayerNorm sits at its trivial value."""
    shapes = architecture(model_cfg).parameter_shapes(model_cfg)
    total = sum(int(np.prod(s)) for _, s, _ in shapes)
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(2 * total, generator=g, device=device) * 0.02
    out, off = {}, 0
    for k, s, kind in shapes:
        n = int(np.prod(s))
        w = flat[off:off + n].view(s).clone()
        if kind == "linear":
            w += flat[total + off:total + off + n].view(s)
        elif kind == "norm":
            w += 1.0
        out[k] = w
        off += n
    return out


# -------------------------------------------------------------------- poses
# Human3.6M-like intrinsics in normalised units: fx fy cx cy k1 k2 k3 p1 p2
DEFAULT_CAM = np.array([2.29, 2.287, 0.025, 0.028, -0.207, 0.247, -0.003, -0.001, -0.0014],
                       dtype=np.float32)


def smooth_noise(rng, T, shape, smoothing=9):
    """Temporally smoothed Gaussian noise (a random walk of poses)."""
    x = rng.randn(T + smoothing, *shape).astype(np.float32)
    kernel = np.ones(smoothing, dtype=np.float32) / smoothing
    x = np.apply_along_axis(lambda a: np.convolve(a, kernel, mode="valid"), 0, x)
    return x[:T]


def make_sequence(torch, rng, T, num_joints=17, depth=4.0):
    """One synthetic take: (pose3d (T, J, 3) camera space, the root joint
    absolute and the others relative to it; pose2d (T, J, 2) projected)."""
    local = 0.35 * smooth_noise(rng, T, (num_joints, 3))
    local[:, 0] = 0.0
    traj = 0.5 * smooth_noise(rng, T, (1, 3))
    traj[..., 2] += depth
    pose_abs = local + traj
    pose2d = project_to_2d(torch.from_numpy(pose_abs.reshape(1, -1, 3)),
                           torch.from_numpy(DEFAULT_CAM[None])).numpy().reshape(T, num_joints, 2)
    pose3d = pose_abs.copy()
    pose3d[:, 1:] -= pose3d[:, :1]
    return pose3d.astype(np.float32), pose2d.astype(np.float32)


def make_dataset(torch, seed, lengths, num_joints=17):
    """(cams, poses_3d, poses_2d): one synthetic take of each length."""
    rng = np.random.RandomState(seed % 2 ** 32)
    cams, p3, p2 = [], [], []
    for T in lengths:
        a, b = make_sequence(torch, rng, T, num_joints)
        cams.append(DEFAULT_CAM.copy())
        p3.append(a)
        p2.append(b)
    return cams, p3, p2


# ------------------------------------------------------------------- device
def device_info(torch, device, chips):
    """The result line's "device" (before the trace's busy and window)."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}

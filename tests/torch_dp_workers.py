"""Data- and tensor-parallel runs of the port for
tests/test_torch_parallel.py and tests/test_torch_tp.py: the ranks' side,
imported by the spawned rank processes, so it imports torch and the port
only (no JAX).

`run_tasks(inputs, mesh)` runs every task on one rank of `mesh`, or on one
device with mesh=None (the port's one-process reference), and returns
numpy results (parameters whole, gathered over a tp group);
`rank_main(inputs_path, out_dir, dp, tp)` is the spawned ranks' entry.
`inputs["cfg"]`, where given, replaces the model config CFG.
"""

import os

import numpy as np
import torch

from d3dp_tpu_torch.data.generators import UnchunkedGenerator
from d3dp_tpu_torch.data.windowing import sample_windows
from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.eval import Evaluator, Evaluator3DHP
from d3dp_tpu_torch.models import MixSTEConfig
from d3dp_tpu_torch.parallel import gather_params, make_mesh, shard_batch_fn, shard_model_params
from d3dp_tpu_torch.train import checkpoint_io
from d3dp_tpu_torch.train.state import make_optimizer, make_train_step

F, H, K = 27, 2, 2
CFG = dict(num_frames=F, num_joints=17, embed_dim=64, depth=2, num_heads=8)
LR_TRAIN = 1e-3


def provider(seed, n_h, n_k, bs):
    """noise_provider(n) replaying a seeded stream, one global micro-batch
    of `bs` rows a call, the first n returned."""
    rng = np.random.RandomState(seed)

    def fn(n):
        img0 = rng.randn(bs, n_h, F, 17, 3).astype(np.float32)
        steps = rng.randn(n_k, bs, n_h, F, 17, 3).astype(np.float32)
        return img0[:n].copy(), steps[:, :n].copy()
    return fn


def d3dp(inputs, drop_path_rate=0.0, mesh=None, **kw):
    """The port's D3DP on the CPU with the inputs' weights, split over the
    mesh's tp ranks (`shard_model_params`)."""
    cfg = MixSTEConfig(**inputs.get("cfg", CFG), drop_path_rate=drop_path_rate)
    out = D3DP(D3DPConfig(model=cfg, **kw), device="cpu")
    out.model.load_state_dict(inputs["state_dict"])
    shard_model_params(out.model, mesh)
    return out


def _train(inputs, mesh):
    """Two steps, each batch padded as the train loop pads it under dp=2
    (on one device too: its pad rows weigh 0, and t, the noise and the
    DropPath masks are drawn for the padded batch, as under dp=2); the
    loss and the parameters after each step, and a checkpoint of the
    result with the number of writes this rank made."""
    td = d3dp(inputs, drop_path_rate=0.1, mesh=mesh)
    opt = make_optimizer(td.model.parameters(), LR_TRAIN)
    step = make_train_step(td, opt, mesh=mesh)
    g = torch.Generator().manual_seed(inputs["train_seed"])
    losses, params = [], []
    for x2d, x3d, w, t, noise in inputs["train_batches"]:
        pad = len(t) - len(w)
        batch = (None, x3d, x2d, w)
        if mesh is not None:
            batch = shard_batch_fn(mesh)(batch)
        else:
            batch = tuple(None if a is None else np.pad(a, ((0, pad),) + ((0, 0),) * (a.ndim - 1))
                          for a in batch)
        _, b3, b2, bw = batch
        losses.append(float(step(b2, b3, bw, generator=g, t_noise_override=(t, noise))))
        params.append({n: p.numpy().copy() for n, p in gather_params(td.model).items()})
    writes = []
    save = torch.save
    try:
        torch.save = lambda *a, **k: (writes.append(1), save(*a, **k))
        checkpoint_io.save_checkpoint(inputs["ckpt_path"], epoch=2, lr=LR_TRAIN, model=td.model,
                                      optimizer=opt)
    finally:
        torch.save = save
    return dict(losses=np.asarray(losses), params=params, writes=len(writes))


def _evaluate(inputs, mesh):
    """Evaluator with replayed noise: host P2, device P2, light, and the
    prediction return of the first sequence."""
    lr = dict(kps_left=inputs["kps_left"], kps_right=inputs["kps_right"])
    td = d3dp(inputs, num_proposals=H, sampling_timesteps=K, joints_left=inputs["joints_left"],
              joints_right=inputs["joints_right"], mesh=mesh)
    out = {}
    for name, kw in (("p2", dict(p2=True)), ("p2_device", dict(p2_device=True)),
                     ("light", dict(light=True))):
        ev = Evaluator(td, receptive_field=F, batch_size=4, mesh=mesh, **lr, **kw)
        res = ev.evaluate(UnchunkedGenerator(*inputs["eval_data"]),
                          noise_provider=provider(11, H, K, 4))
        out[name] = (res.n, res.averages_mm(), res.averages_p2_mm())
    ev = Evaluator(td, receptive_field=F, batch_size=4, mesh=mesh, **lr)
    out["predictions"] = ev.evaluate(UnchunkedGenerator(*inputs["eval_data"]),
                                     noise_provider=provider(12, H, K, 4),
                                     return_predictions=True)
    return out


def _evaluate_3dhp(inputs, mesh):
    td = d3dp(inputs, num_proposals=H, sampling_timesteps=K, joints_left=inputs["kps_3dhp"][0],
              joints_right=inputs["kps_3dhp"][1], unit_scale=1000.0, mesh=mesh)
    p3, p2, valid = inputs["data_3dhp"]
    keys = list(p2)
    gen = UnchunkedGenerator(None, [p3[k] for k in keys], [p2[k] for k in keys],
                             valid_frames=[valid[k] for k in keys], keys=keys)
    return Evaluator3DHP(td, receptive_field=F, batch_size=2, mesh=mesh).evaluate(
        gen, noise_provider=provider(13, H, K, 2))


def _sample_windows(inputs, mesh):
    """sample_windows with the global draws replaced by the inputs' stream
    (JAX's key-driven draws in the tests), one entry a micro-batch."""
    td = d3dp(inputs, num_proposals=H, sampling_timesteps=K, joints_left=inputs["joints_left"],
              joints_right=inputs["joints_right"], mesh=mesh)
    draws = iter(inputs["window_noise"])
    td.sample_noise = lambda B, generator: tuple(torch.from_numpy(a) for a in next(draws))
    w2d, w2d_f, bs = inputs["windows"]
    return sample_windows(td, w2d, w2d_f, bs, None, mesh=mesh)


def run_tasks(inputs, mesh=None):
    """Every task; sample_windows only under a mesh, where its draws go
    through `sample_noise` and so can be replaced."""
    torch.set_num_threads(1)
    return dict(train=_train(inputs, mesh), evaluate=_evaluate(inputs, mesh),
                evaluate_3dhp=_evaluate_3dhp(inputs, mesh),
                sample_windows=None if mesh is None else _sample_windows(inputs, mesh))


def rank_main(inputs_path, out_dir, dp=2, tp=1, tasks=run_tasks):
    """One spawned rank: a (dp, tp) CPU mesh over the process group,
    `tasks(inputs, mesh)` (every task by default), the results into
    out_dir/rank<r>.pt; the checkpoint to out_dir/dp<dp>[tp<tp>].ckpt."""
    inputs = torch.load(inputs_path, weights_only=False)
    mesh = make_mesh(dp=dp, tp=tp, devices=["cpu"] * (dp * tp))
    name = f"dp{dp}" + (f"tp{tp}" if tp > 1 else "")
    inputs = dict(inputs, ckpt_path=os.path.join(out_dir, f"{name}.ckpt"))
    out = tasks(inputs, mesh)
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))

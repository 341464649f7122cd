"""Tensor-parallel runs of the port for tests/test_torch_tp.py and
tests/test_torch_tp_ranks.py: the ranks' side (torch and the port only, no
JAX), beside tests/torch_dp_workers.py, whose `rank_main` starts them.

`sample_tasks(inputs, mesh)`: `D3DP.sample` at fuse levels 0-5 and at
level 5 with DDIM feature reuse on injected noise, the gradients of one
training forward, and a checkpoint round trip. `train_eval_tasks(inputs,
mesh)`: the training steps, the Evaluator (host and device P2) and the 3DHP
evaluator of torch_dp_workers. `fused_tasks(inputs, mesh)`: the paths that
tp took last: `sample` at level 4 under `D3DP_ATTN_VARIANT=hmqkv`, the loss
and every gradient of one `D3DP_TRAIN_FUSED=1` forward at fuse levels 1, 2
and 4 with DropPath, a few such steps, and the `--ckpt-format orbax` (DCP)
checkpoints across tp 1 and 2. With mesh=None, the one-process reference.
"""

import contextlib
import os

import numpy as np
import torch

from d3dp_tpu_torch.diffusion import D3DP, D3DPConfig
from d3dp_tpu_torch.models import MixSTEConfig
from d3dp_tpu_torch.parallel import mesh as tmesh
from d3dp_tpu_torch.parallel import shard_model_params
from d3dp_tpu_torch.train import checkpoint_io
from d3dp_tpu_torch.train.state import make_optimizer, make_train_step, weighted_mpjpe
from tests import torch_dp_workers as W

LEVELS = (0, 1, 2, 3, 4, 5)


def sampler(inputs, mesh, level, drop_path_rate=0.0, **kw):
    """The port's D3DP at a fuse level with the inputs' weights, split over
    the mesh's tp ranks."""
    cfg = MixSTEConfig(**inputs["cfg"], fuse_level=level, drop_path_rate=drop_path_rate)
    out = D3DP(D3DPConfig(model=cfg, num_proposals=W.H, **kw), device="cpu")
    out.model.load_state_dict(inputs["state_dict"])
    shard_model_params(out.model, mesh)
    return out


def _sample(inputs, mesh):
    """{level: prediction} on the inputs' noise; "5 reuse": level 5 with
    feature reuse (interval 2, tap 1, 3 steps), which runs level 4's flow."""
    x2d, x2d_f = (torch.from_numpy(a) for a in inputs["sample_x2d"])
    out = {}
    for level in LEVELS:
        d = sampler(inputs, mesh, level, sampling_timesteps=W.K)
        out[level] = d.sample(x2d, x2d_f, noise_override=inputs["sample_noise"]).numpy()
    d = sampler(inputs, mesh, 5, sampling_timesteps=3, reuse_interval=2, reuse_tap=1)
    out["5 reuse"] = d.sample(x2d, x2d_f, noise_override=inputs["reuse_noise"]).numpy()
    return out


def _grads(inputs, mesh):
    """{name: gradient} of the replicated parameters after one fp32
    training forward and backward (DropPath on, the inputs' masks, t and
    noise), and the loss."""
    d = sampler(inputs, mesh, 4, drop_path_rate=0.1, sampling_timesteps=W.K)
    x2d, x3d, t, noise = (torch.from_numpy(a) for a in inputs["grad_batch"])
    pred = d.train_forward(x2d, x3d, t_noise_override=(t, noise),
                           droppath_masks=inputs["grad_masks"])
    loss = (pred - x3d).square().mean()
    loss.backward()
    split = {n for n, p in d.model.named_parameters()
             if p.shape != inputs["state_dict"][n].shape}
    return dict(loss=float(loss.detach()), split=sorted(split),
                grads={n: p.grad.numpy().copy() for n, p in d.model.named_parameters()
                       if n not in split})


def _checkpoint(inputs, mesh):
    """Load the one-process checkpoint at inputs["ref_ckpt"] (weights and
    AdamW state) into a split model and its optimizer, then save it again
    to inputs["ckpt_path"]: the round trip through `shard_checkpoint` and
    the gathering save."""
    d = sampler(inputs, mesh, 4, sampling_timesteps=W.K)
    opt = make_optimizer(d.model.parameters(), W.LR_TRAIN)
    ckpt = checkpoint_io.shard_checkpoint(checkpoint_io.load_any(inputs["ref_ckpt"]), d.model)
    d.model.load_state_dict(ckpt["model"])
    opt.load_state_dict(ckpt["optimizer"])
    checkpoint_io.save_checkpoint(inputs["ckpt_path"], epoch=ckpt["epoch"], lr=ckpt["lr"],
                                  model=d.model, optimizer=opt)
    return os.path.exists(inputs["ckpt_path"])


def sample_tasks(inputs, mesh=None):
    torch.set_num_threads(1)
    return dict(sample=_sample(inputs, mesh), grads=_grads(inputs, mesh),
                checkpoint=None if mesh is None else _checkpoint(inputs, mesh))


def train_eval_tasks(inputs, mesh=None):
    """torch_dp_workers' training steps, the Evaluator with host and device
    P2 (no light mode or prediction return: those are the evaluator's own,
    held by tests/test_torch_parallel.py) and, unless inputs["no_3dhp"],
    the 3DHP evaluator."""
    torch.set_num_threads(1)
    lr = dict(kps_left=inputs["kps_left"], kps_right=inputs["kps_right"])
    td = W.d3dp(inputs, num_proposals=W.H, sampling_timesteps=W.K,
                joints_left=inputs["joints_left"], joints_right=inputs["joints_right"],
                mesh=mesh)
    evaluate = {}
    for name, kw in (("p2", dict(p2=True)), ("p2_device", dict(p2_device=True))):
        ev = W.Evaluator(td, receptive_field=W.F, batch_size=4, mesh=mesh, **lr, **kw)
        res = ev.evaluate(W.UnchunkedGenerator(*inputs["eval_data"]),
                          noise_provider=W.provider(11, W.H, W.K, 4))
        evaluate[name] = (res.n, res.averages_mm(), res.averages_p2_mm())
    return dict(train=W._train(inputs, mesh), evaluate=evaluate,
                evaluate_3dhp=None if inputs.get("no_3dhp") else W._evaluate_3dhp(inputs, mesh))


def grad_masks(model, B, seed):
    """DropPath masks of a training forward on B rows, drawn as the model
    draws them, as numpy."""
    g = torch.Generator().manual_seed(seed)
    return {k: tuple(m.numpy() for m in v) for k, v in model.draw_droppath_masks(B, g).items()}


def one_step_checkpoint(inputs, path):
    """The one-process checkpoint `_checkpoint` round-trips: the inputs'
    weights after one AdamW step on the grad batch (moments non-zero)."""
    d = sampler(inputs, None, 4, sampling_timesteps=W.K)
    opt = make_optimizer(d.model.parameters(), W.LR_TRAIN)
    x2d, x3d, t, noise = (torch.from_numpy(a) for a in inputs["grad_batch"])
    d.train_forward(x2d, x3d, t_noise_override=(t, noise)).square().mean().backward()
    opt.step()
    checkpoint_io.save_checkpoint(path, epoch=1, lr=W.LR_TRAIN, model=d.model, optimizer=opt)


def rng_batch(seed, B, F, J=17):
    rng = np.random.RandomState(seed)
    return ((rng.randn(B, F, J, 2) * 0.3).astype(np.float32),
            (rng.randn(B, F, J, 3) * 0.3).astype(np.float32))


# ------------------------------------------------------------ fused_tasks
FUSED_LEVELS = (1, 2, 4)
FUSED_STEPS = 3


@contextlib.contextmanager
def env(name, value):
    """One environment variable set for a block (a lab switch)."""
    saved = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop(name)
        else:
            os.environ[name] = saved


def whole_grads(model):
    """{name: gradient} of every parameter, a split one's gathered over its
    tp group (every rank takes part)."""
    spec = tmesh.mixste_param_spec(dict(model.named_parameters()))
    out = {}
    for n, p in model.named_parameters():
        g = p.grad if model.tp is None else tmesh.gather_tensor(n, p.grad, spec[n], model.tp)
        out[n] = g.numpy().copy()
    return out


def _fused(inputs):
    """The inputs with the training model's config and weights."""
    return dict(inputs, cfg=inputs["fused_cfg"], state_dict=inputs["fused_state_dict"])


def _fused_grads(inputs, mesh, level):
    """Loss and every (gathered) gradient of one fp32 `D3DP_TRAIN_FUSED=1`
    training forward at `level`, DropPath 0.1 with the inputs' masks, and
    the replicated parameters' gradients as this rank holds them."""
    d = sampler(_fused(inputs), mesh, level, drop_path_rate=0.1)
    x2d, x3d, t, noise, w = (torch.from_numpy(a) for a in inputs["fused_batch"])
    pred = d.train_forward(x2d, x3d, t_noise_override=(t, noise),
                           droppath_masks=inputs["fused_masks"])
    loss = weighted_mpjpe(pred, x3d, w)
    loss.backward()
    spec = tmesh.mixste_param_spec(dict(d.model.named_parameters()))
    return dict(loss=float(loss.detach()), grads=whole_grads(d.model),
                replicated={n: p.grad.numpy().copy() for n, p in d.model.named_parameters()
                            if spec[n] is None})


def _fused_steps(inputs, mesh):
    """FUSED_STEPS `D3DP_TRAIN_FUSED=1` AdamW steps at level 4 (DropPath
    0.1 drawn by the step from one seeded generator): the losses, the whole
    parameters after them, the replicated ones as this rank holds them, and
    the model and optimizer (for the checkpoint task)."""
    d = sampler(_fused(inputs), mesh, 4, drop_path_rate=0.1)
    opt = make_optimizer(d.model.parameters(), W.LR_TRAIN)
    step = make_train_step(d, opt, mesh=mesh)
    g = torch.Generator().manual_seed(13)
    x2d, x3d, _, _, w = inputs["fused_batch"]
    losses = [float(step(x2d, x3d, w, generator=g)) for _ in range(FUSED_STEPS)]
    spec = tmesh.mixste_param_spec(dict(d.model.named_parameters()))
    whole = {n: p.numpy().copy() for n, p in tmesh.gather_params(d.model).items()}
    replicated = {n: p.detach().numpy().copy() for n, p in d.model.named_parameters()
                  if spec[n] is None}
    return dict(losses=losses, params=whole, replicated=replicated), d, opt


def _dcp_checkpoints(inputs, mesh, d, opt):
    """`--ckpt-format orbax`: save the stepped model and optimizer as a DCP
    directory (asynchronously, then waited for) to inputs["dcp_out"]; under
    a mesh also load the one-process directory inputs["dcp_ref"] into a
    split model (`shard_checkpoint`) and save it again as a pickle, to
    inputs["dcp_back"]: both are free of the tp layout."""
    rs = np.random.RandomState(21)
    rs.rand(7)
    checkpoint_io.save_checkpoint_any(inputs["dcp_out"], "orbax", epoch=3, lr=W.LR_TRAIN,
                                      model=d.model, optimizer=opt, generator_random_state=rs,
                                      min_loss=12.5, wait=False)
    checkpoint_io.wait_for_checkpoints()
    if mesh is None:
        return None
    e = sampler(_fused(inputs), mesh, 4)
    opt2 = make_optimizer(e.model.parameters(), W.LR_TRAIN)
    ck = checkpoint_io.shard_checkpoint(checkpoint_io.load_any(inputs["dcp_ref"]), e.model)
    e.model.load_state_dict(ck["model"])
    opt2.load_state_dict(ck["optimizer"])
    checkpoint_io.save_checkpoint(inputs["dcp_back"], epoch=ck["epoch"], lr=ck["lr"],
                                  model=e.model, optimizer=opt2,
                                  generator_random_state=ck["random_state"],
                                  min_loss=ck["min_loss"])
    return True


def fused_tasks(inputs, mesh=None):
    torch.set_num_threads(1)
    x2d, x2d_f = (torch.from_numpy(a) for a in inputs["sample_x2d"])
    with env("D3DP_ATTN_VARIANT", "hmqkv"):
        d = sampler(inputs, mesh, 4, sampling_timesteps=W.K)
        hm = d.sample(x2d, x2d_f, noise_override=inputs["sample_noise"]).numpy()
    with env("D3DP_TRAIN_FUSED", "1"):
        grads = {level: _fused_grads(inputs, mesh, level) for level in FUSED_LEVELS}
        steps, d, opt = _fused_steps(inputs, mesh)
    name = "dcp_tp2" if mesh is not None else "dcp_tp1"
    inputs = dict(inputs, dcp_out=os.path.join(inputs["tmp"], f"{name}.orbax"),
                  dcp_ref=os.path.join(inputs["tmp"], "dcp_tp1.orbax"),
                  dcp_back=os.path.join(inputs["tmp"], "dcp_tp1_at_tp2.ckpt"))
    return dict(hm_sample=hm, fused_grads=grads, fused_steps=steps,
                dcp=_dcp_checkpoints(inputs, mesh, d, opt))

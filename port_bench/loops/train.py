"""Traffic kind "train": the training loop of cli/main_h36m.py::run_training,
ChunkedGenerator -> Prefetcher -> make_train_step, losses kept on the
device.

Set-up builds the one step (model, AdamW, generator of the step's draws)
and drives it through its first `check_steps` steps from the same
Prefetcher the window goes on with; those steps are the warm-up, and their
losses, the first step's gradient (from AdamW's first moment) and the
parameters' change are what the reference is held to. The window then runs
steps until the deadline; a CUDA event after each step marks its end.

End-to-end: train_frames_per_s, frames x real chunks of the steps the
device finished by the deadline over the device time to the last of them;
train_step_p95_ms, the 95th percentile of their completion-to-completion
intervals (the first from the window's start).
"""

import time

import numpy as np

from port_bench.arch import architecture
from port_bench.harness.common import make_dataset, make_program, sub_seed
from port_bench.reference import feed as ref_feed
from port_bench.reference import train as ref_train
from port_bench.reference.precision import matmul_fn


def leaf_norms(torch, tensors):
    """{name: float64 norm}."""
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in tensors.items()}


def worst_leaf_gap(got, want, leaves):
    """(max over `leaves` of |got - want| / max(want, the median leaf's
    want), the leaf that reads it)."""
    med = float(np.median([want[k] for k in leaves]))
    return max((abs(got[k] - want[k]) / max(want[k], med), k) for k in leaves)


class Loop:
    def __init__(self, run):
        self.run = run
        self.torch = run.torch
        self.traffic = run.traffic
        self.model_cfg = run.config["model"]
        self.diff = run.config["diffusion"]
        self.arch = architecture(self.model_cfg)

    def setup(self):
        torch, run, tr, m, cfg = self.torch, self.run, self.traffic, self.model_cfg, self.run.config
        from d3dp_tpu_torch.data.generators import ChunkedGenerator
        from d3dp_tpu_torch.data.prefetch import Prefetcher
        from d3dp_tpu_torch.train.state import make_optimizer, make_train_step

        self.Prefetcher = Prefetcher
        self.d3dp = make_program(self.arch, cfg, run.device,
                                 sub_seed(run.seed, "model") % 2 ** 31)
        self.d3dp.model.load_state_dict(run.weights())
        self.opt = make_optimizer(self.d3dp.model.parameters(), tr["learning_rate"],
                                  weight_decay=tr["weight_decay"])
        self.step = make_train_step(self.d3dp, self.opt)
        run.phase("model")
        self.data = make_dataset(torch, sub_seed(run.seed, "data"), tr["lengths"],
                                 m["num_joints"])
        self.shuffle_seed = sub_seed(run.seed, "shuffle") % 2 ** 32
        self.gen = ChunkedGenerator(
            tr["chunks_per_batch"], *self.data, m["num_frames"], shuffle=True,
            random_seed=self.shuffle_seed, augment=tr["augment"],
            kps_left=list(cfg["kps_left"]), kps_right=list(cfg["kps_right"]),
            joints_left=list(cfg["joints_left"]), joints_right=list(cfg["joints_right"]),
            pad_last=True)
        self.g = torch.Generator(device=run.device).manual_seed(sub_seed(run.seed, "draws"))
        self.batches = self._batches()
        run.phase("data")
        # the first steps: warm-up, and the readings the reference checks
        n = tr["check_steps"]
        self.states, losses = [], []
        for _ in range(n):
            self.states.append(self.g.get_state())
            _, b3, b2, w = next(self.batches)
            losses.append(self.step(b2, b3, w, generator=self.g))
            if len(losses) == 1:
                # AdamW's first moment after one step is (1 - beta1) x the gradient
                self.prog_grad = leaf_norms(torch, {
                    k: self.opt.state[p].get("exp_avg", torch.zeros_like(p)) / 0.1
                    for k, p in self.d3dp.model.named_parameters()})
        start = run.weights()
        params = dict(self.d3dp.model.named_parameters())
        self.prog_update = leaf_norms(torch, {k: params[k].detach() - start[k] for k in start})
        self.prog_losses = [float(v) for v in losses]
        del start, params
        run.sync()
        run.phase("first steps")

    def _batches(self):
        """The loop's batches, epoch after epoch, each from the Prefetcher
        as run_training takes them; the wait for each is a span."""
        while True:
            it = iter(self.Prefetcher(self.gen.next_epoch(), depth=2))
            while True:
                with self.run.spans.span("batch_wait"):
                    item = next(it, None)
                if item is None:
                    break
                yield item

    def _event(self):
        if self.run.device.type != "cuda":
            return None
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def window(self, seconds):
        torch, run = self.torch, self.run
        steps, losses = [], []  # (real chunks, end event, host end)
        start = self._event()
        t0 = time.perf_counter()
        with run.tracer.window(torch):
            while time.perf_counter() < t0 + seconds:
                _, b3, b2, w = next(self.batches)
                with run.spans.span("step"):
                    losses.append(self.step(b2, b3, w, generator=self.g))
                steps.append((int(w.sum()), self._event(), time.perf_counter()))
        run.sync()
        ends = [start.elapsed_time(ev) / 1e3 if start is not None else t - t0
                for _, ev, t in steps]
        n = max(1, sum(1 for e in ends if e <= seconds))  # at least the first step
        self.window_s = ends[n - 1]
        self.chunks = sum(c for c, _, _ in steps[:n])
        self.attempted = n
        finite = torch.stack(losses[:n]).isfinite().tolist()
        self.failed = sum(1 for ok in finite if not ok)
        intervals = np.diff([0.0] + ends[:n]) * 1e3
        self.steps_in_trace = len(steps)
        return {"train_frames_per_s": self.chunks * self.model_cfg["num_frames"] / self.window_s,
                "train_step_p95_ms": float(np.percentile(intervals, 95))}

    def counts(self):
        return dict(steps=self.steps_in_trace, completed=self.attempted, real_chunks=self.chunks,
                    batch=self.traffic["chunks_per_batch"],
                    batch_wait_ms=self.run.spans.durations_ms("batch_wait"))

    def release(self):
        del self.step, self.opt, self.d3dp, self.batches

    # ------------------------------------------------------------- check
    def readings(self, control=None, fault=None):
        """loss_gap (the largest relative gap of a step's loss), grad_gap and
        update_gap (the worst leaf's gap of the first gradient's norm and of
        the change's norm over the checked steps, against that leaf's or the
        median leaf's reference norm, whichever is larger). `control`: the
        reference in that precision in the program's place; `fault`
        "half_batch": the same with the loss over the first half of the
        rows."""
        torch, run, tr, m, cfg = self.torch, self.run, self.traffic, self.model_cfg, self.run.config
        dev = run.device
        n = tr["check_steps"]
        B = tr["chunks_per_batch"]
        batches = ref_feed.train_batches(
            self.data[1], self.data[2], m["num_frames"], B, self.shuffle_seed, tr["augment"],
            (cfg["kps_left"], cfg["kps_right"]), (cfg["joints_left"], cfg["joints_right"]), n)
        draws = [self.arch.step_draws(s, dev, B, m, self.diff["timesteps"]) for s in self.states]

        def trained(dt, mm=torch.matmul, keep_rows=None):
            weights = run.weights()
            model = self.arch.reference(m, weights, dt, dev)
            tb = [tuple(torch.from_numpy(a).to(dev) for a in b) for b in batches]
            losses, grads, params = ref_train.run_steps(
                model, tb, draws, self.diff, tr["learning_rate"], tr["weight_decay"],
                keep_rows=keep_rows, mm=mm)
            update = leaf_norms(torch, {k: params[k].double() - weights[k].double()
                                        for k in weights})
            del model
            return losses, leaf_norms(torch, grads), update

        ref_losses, ref_grad, ref_update = trained(torch.float64)
        if control is not None:
            got = trained(torch.float32, mm=matmul_fn(control))
        elif fault == "half_batch":
            got = trained(torch.float64, keep_rows=B // 2)
        else:
            got = (self.prog_losses, self.prog_grad, self.prog_update)
        med = float(np.median(list(ref_grad.values())))
        moved = [k for k, v in ref_grad.items() if v >= 1e-3 * med]
        grad_gap, grad_leaf = worst_leaf_gap(got[1], ref_grad, list(ref_grad))
        update_gap, update_leaf = worst_leaf_gap(got[2], ref_update, moved)
        return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got[0], ref_losses)),
                "grad_gap": grad_gap, "update_gap": update_gap,
                "worst_leaves": [grad_leaf, update_leaf],
                "left_out_leaves": sorted(set(ref_grad) - set(moved))}

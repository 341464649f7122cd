"""Traffic kind "eval": Protocol-1 evaluation as the command line's
action-wise loop runs it (cli/main_h36m.py::run_evaluation).

Each `Evaluator.evaluate` call takes one action: the traffic file's
sequence lengths, one synthetic take each (the traffic's `actions` sets of
takes are made in set-up and taken in turn), and a sampling generator of
its own; its result is read as `report_result` reads it. Every call to
`D3DP.sample` passes through `_Sampler`, which closes the window: the first
call after the deadline ends the evaluation in progress, and only the
micro-batches whose scores the device finished by the deadline count.

End-to-end: eval_hypframes_per_s, the real (unpadded) windows x H x F x K of
the counted micro-batches over the device time from the window's start to
the last of them.
"""

import itertools
import time

import numpy as np

from port_bench.arch import architecture
from port_bench.harness.common import make_dataset, make_program, sub_seed
from port_bench.reference import diffusion as ref_diffusion
from port_bench.reference import feed as ref_feed
from port_bench.reference.modes import four_modes
from port_bench.reference.precision import matmul_fn

MODES = ("J_Best", "P_Best", "P_Agg", "J_Agg")


class WindowClosed(Exception):
    """Raised into the evaluation by the first `sample` after the deadline."""


class _Sampler:
    """The D3DP the Evaluator sees: each `sample` call timed on the host
    and by CUDA events, its generator state kept, its output kept for the
    micro-batches the check reads (`keep`)."""

    def __init__(self, torch, d3dp, spans, marker):
        self.torch, self.d3dp, self.spans, self.marker = torch, d3dp, spans, marker
        self.device, self.cfg = d3dp.device, d3dp.cfg
        self.calls, self.keep, self.deadline = [], set(), None

    def event(self):
        if self.device.type != "cuda":
            return None
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def sample(self, x2d, x2d_flip=None, generator=None, noise_override=None, **kw):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise WindowClosed
        i = len(self.calls)
        call = dict(state=generator.get_state() if i in self.keep else None,
                    t0=time.perf_counter(), ev0=self.event())
        self.marker()
        with self.spans.span("sample"):
            out = self.d3dp.sample(x2d, x2d_flip, generator=generator,
                                   noise_override=noise_override, **kw)
        self.marker()
        call.update(t1=time.perf_counter(), ev1=self.event(), out=out if i in self.keep else None)
        self.calls.append(call)
        return out


def _evaluator_class(Evaluator, spans):
    class Scored(Evaluator):
        """The port's Evaluator; its scoring is a span, its error vectors
        kept and the micro-batch's end marked by a CUDA event."""

        def _score(self, *args, **kwargs):
            with spans.span("score"):
                out = super()._score(*args, **kwargs)
            call = self.d3dp.calls[-1]
            call.update(errors=out[0], done=self.d3dp.event(), t_done=time.perf_counter())
            return out

    return Scored


class Loop:
    def __init__(self, run):
        self.run = run
        self.torch = run.torch
        self.traffic = run.traffic
        self.model_cfg = run.config["model"]
        self.diff = run.config["diffusion"]
        self.arch = architecture(self.model_cfg)

    # ------------------------------------------------------------ set-up
    def setup(self):
        torch, run, tr, m = self.torch, self.run, self.traffic, self.model_cfg
        from d3dp_tpu_torch.data.generators import UnchunkedGenerator
        from d3dp_tpu_torch.eval import Evaluator

        self.UnchunkedGenerator = UnchunkedGenerator
        cfg = run.config
        d3dp = make_program(self.arch, cfg, run.device, sub_seed(run.seed, "model") % 2 ** 31,
                            sampling_timesteps=tr["sampling_timesteps"],
                            num_proposals=tr["num_proposals"])
        d3dp.model.load_state_dict(run.weights())
        run.phase("model")
        self.sampler = _Sampler(torch, d3dp, run.spans, run.marker)
        self.evaluator = _evaluator_class(Evaluator, run.spans)(
            self.sampler, receptive_field=m["num_frames"], batch_size=tr["batch_size"],
            kps_left=list(cfg["kps_left"]), kps_right=list(cfg["kps_right"]))
        self.actions = [make_dataset(torch, sub_seed(run.seed, "action", a), tr["lengths"],
                                     m["num_joints"]) for a in range(tr["actions"])]
        self.schedule = ref_feed.microbatches(tr["lengths"], m["num_frames"], tr["batch_size"])
        run.phase("data")
        # warm-up: one sequence of one micro-batch, every shape of the window
        warm = make_dataset(torch, sub_seed(run.seed, "warm-up"),
                            [m["num_frames"] * tr["batch_size"]], m["num_joints"])
        for _ in range(2):
            self._evaluate(warm, sub_seed(run.seed, "warm-up rng"))
        run.sync()
        run.phase("warm-up")
        first = self.sampler.calls[-1]
        self.mb_s = (first["ev0"].elapsed_time(first["done"]) / 1e3 if first["ev0"] is not None
                     else first["t_done"] - first["t0"])
        self.sampler.calls.clear()

    def _evaluate(self, data, seed):
        gen = self.UnchunkedGenerator(*data)
        rng = self.torch.Generator(device=self.run.device).manual_seed(seed)
        with self.run.spans.span("evaluate"):
            result = self.evaluator.evaluate(gen, rng)
        with self.run.spans.span("report"):
            result.averages_mm()

    # ------------------------------------------------------------ window
    def window(self, seconds):
        torch, run, s = self.torch, self.run, self.sampler
        n_est = max(1, int(0.8 * seconds / self.mb_s))
        rng = np.random.RandomState(sub_seed(run.seed, "check") % 2 ** 32)
        k = min(self.traffic["check_microbatches"], n_est)
        # the first micro-batch, and the rest drawn from those the window
        # will have finished by the estimate of the warm-up's time
        s.keep = {0} | set(rng.choice(np.arange(1, n_est), size=k - 1, replace=False).tolist())
        start = s.event()
        t0 = time.perf_counter()
        s.deadline = t0 + seconds
        with run.tracer.window(torch):
            for c in itertools.count():
                try:
                    self._evaluate(self.actions[c % len(self.actions)],
                                   sub_seed(run.seed, "rng", c))
                except WindowClosed:
                    break
        run.sync()
        wall = time.perf_counter() - t0
        done = []  # (index, completion s)
        for i, call in enumerate(s.calls):
            if "errors" not in call:
                continue
            at = (start.elapsed_time(call["done"]) / 1e3 if start is not None
                  else call["t_done"] - t0)
            if at <= seconds or not done:  # a window shorter than a micro-batch counts one
                done.append((i, at))
        self.done = done
        tr, m = self.traffic, self.model_cfg
        per_window = tr["num_proposals"] * m["num_frames"] * tr["sampling_timesteps"]
        self.real_windows = sum(self._mb(i)[3] for i, _ in done)
        self.window_s = done[-1][1] if done else wall
        # every completed micro-batch's error vectors finite: one read
        errs = [torch.stack([s.calls[i]["errors"][mm] for mm in MODES]) for i, _ in done]
        finite = (torch.stack(errs).isfinite().flatten(1).all(1).tolist() if errs else [])
        self.failed = sum(1 for ok in finite if not ok)
        return {"eval_hypframes_per_s": self.real_windows * per_window / self.window_s}

    def _mb(self, i):
        """(action, sequence, micro-batch, real windows) of window call i."""
        a = (i // len(self.schedule)) % len(self.actions)
        return (a, *self.schedule[i % len(self.schedule)])

    def counts(self):
        """What the per-layer readers count with."""
        calls = self.sampler.calls
        done = {i for i, _ in self.done}
        sample_ms = [c["ev0"].elapsed_time(c["ev1"]) for c in calls if c["ev0"] is not None]
        outside_ms = [1e3 * (calls[i + 1]["t0"] - calls[i]["t1"]) for i in range(len(calls) - 1)]
        per_window = (2 if self.diff["flip_tta"] else 1) * self.traffic["num_proposals"]
        return dict(sample_calls=len(calls), completed=len(done), real_windows=self.real_windows,
                    rows=per_window * self.traffic["batch_size"], real_rows_per_window=per_window,
                    sample_ms=sample_ms, evaluator_ms=outside_ms)

    def release(self):
        """Keep the kept outputs, free the program."""
        kept = {i for i, _ in self.done} & self.sampler.keep
        self.kept = {i: (self.sampler.calls[i]["out"], self.sampler.calls[i]["errors"],
                         self.sampler.calls[i]["state"]) for i in sorted(kept)}
        self.attempted = len(self.done)
        del self.evaluator, self.sampler

    # ------------------------------------------------------------- check
    def readings(self, control=None):
        """The compared numbers over the kept micro-batches, in mm:
        pred_gap_mm, the largest |prediction - reference| of a real window
        (the sampler); modes_gap_mm, the largest gap of the four modes'
        per-step errors from the reference's (sampler and scoring);
        score_gap_mm, the largest gap of the four modes from the reference's
        four modes of the program's own predictions (the scoring alone).
        `control` ("tf32" or "fp8"): the reference in that precision is
        judged in the program's place, its modes scored in bfloat16, the
        precision below the scoring's float32."""
        torch, run, tr, m = self.torch, self.run, self.traffic, self.model_cfg
        dev, dt = run.device, torch.float64
        weights = run.weights()
        ref = self.arch.reference(m, weights, dt, dev)
        ctl = None if control is None else self.arch.reference(m, weights, torch.float32, dev)
        mm_units = 1000.0 / self.diff["unit_scale"]
        cfg = run.config
        pred_gap = modes_gap = score_gap = 0.0
        for i, (out, errors, state) in self.kept.items():
            a, s, b, n = self._mb(i)
            cams, p3, p2 = self.actions[a]
            n_, x2d, x2f, target, traj, cam = ref_feed.eval_microbatch(
                cams[s], p3[s], p2[s], m["num_frames"], tr["batch_size"], b,
                cfg["kps_left"], cfg["kps_right"])
            g = torch.Generator(device=dev)
            g.set_state(state)
            bs, H, K = tr["batch_size"], tr["num_proposals"], tr["sampling_timesteps"]
            shape = (bs, H, m["num_frames"], m["num_joints"], 3)
            img0 = torch.randn(shape, generator=g, device=dev)
            steps = torch.randn((K, *shape), generator=g, device=dev)
            t = lambda a_: torch.from_numpy(np.ascontiguousarray(a_)).to(dev, dt)
            args = (t(x2d), t(x2f), img0, steps, self.diff, cfg["joints_left"],
                    cfg["joints_right"])
            want = ref_diffusion.sample(ref, *args)[:n]
            if ctl is not None:
                out = ref_diffusion.sample(ctl, *args, mm=matmul_fn(control))
            got = out[:n].to(dt)
            pred_gap = max(pred_gap, float((got - want).abs().max()) * mm_units)

            def modes(p, ty=dt):
                p = p.to(ty).clone()
                p[..., 0, :] = 0.0
                c = lambda a_: t(a_[:n]).to(ty)
                out = four_modes(p, c(target), c(traj), c(x2d), c(cam))
                return {k: v.to(dt) for k, v in out.items()}

            ref_modes, judged = modes(want), modes(got)
            got_modes = (modes(got, torch.bfloat16) if ctl is not None
                         else {k: v.to(dt) for k, v in errors.items()})
            for k in MODES:
                modes_gap = max(modes_gap,
                                float((got_modes[k] - ref_modes[k]).abs().max()) * mm_units)
                score_gap = max(score_gap,
                                float((got_modes[k] - judged[k]).abs().max()) * mm_units)
        if not self.kept:  # nothing the window produced was checked: not correct
            pred_gap = modes_gap = score_gap = float("inf")
        return {"pred_gap_mm": pred_gap, "modes_gap_mm": modes_gap, "score_gap_mm": score_gap,
                "checked_microbatches": len(self.kept)}

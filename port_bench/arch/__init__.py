"""The architectures a configuration can name: one module each,
port_bench/arch/<name>.py, found by the configuration's `model.arch`
(`mixste2` where the key is absent).

A module gives:

- `parameter_shapes(model_cfg)`: [(state_dict key, shape, kind)] in the
  state_dict's order, kind "linear" (a Linear weight), "norm" (a LayerNorm
  scale) or "other": what `harness.common.make_weights` draws;
- `reference(model_cfg, weights, dtype, device)`: the plain reference
  under `port_bench/reference/`, holding `weights`;
- `denoiser_config(model_cfg)`: the port's configuration of this
  denoiser, which `harness.common.make_program` hands to the port's `D3DP`;
- `step_draws(state, device, B, model_cfg, timesteps)`: (t, noise, masks)
  of one training step, replayed from a generator state in the order the
  program draws them, as the reference's `model(..., masks=)` takes them;
- `forward_flops(model_cfg)`: operations of one forward on one (F, J) row;
- `blocks(model_cfg)`: (spatial, temporal) attention+MLP blocks a forward.
"""

import importlib
import re

DEFAULT = "mixste2"
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def architecture(model_cfg):
    """The module of the architecture that the configuration's `model`
    names; refuses a name that has none."""
    name = model_cfg.get("arch", DEFAULT)
    module = f"{__name__}.{name}"
    if isinstance(name, str) and _NAME.fullmatch(name):
        try:
            return importlib.import_module(module)
        except ModuleNotFoundError as e:
            if e.name != module:
                raise
    raise SystemExit(f"the configuration names architecture {name!r}, which has no module "
                     f"port_bench/arch/{name}.py")

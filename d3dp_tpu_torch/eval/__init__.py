from d3dp_tpu_torch.eval.evaluator import MODES, EvalResult, Evaluator, provider_noise
from d3dp_tpu_torch.eval.evaluator_3dhp import Evaluator3DHP

__all__ = ["MODES", "EvalResult", "Evaluator", "Evaluator3DHP", "provider_noise"]

from d3dp_tpu_torch.eval.evaluator import MODES, EvalResult, Evaluator, provider_noise

__all__ = ["MODES", "EvalResult", "Evaluator", "provider_noise"]

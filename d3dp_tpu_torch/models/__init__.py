from d3dp_tpu_torch.models.mixste import MixSTE2, MixSTEConfig

__all__ = ["MixSTE2", "MixSTEConfig"]

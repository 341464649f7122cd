from d3dp_tpu_torch.in_the_wild.inference import get_detector_2d, inference_video

__all__ = ["inference_video", "get_detector_2d"]

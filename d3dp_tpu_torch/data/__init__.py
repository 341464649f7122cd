from d3dp_tpu_torch.data.generators import UnchunkedGenerator
from d3dp_tpu_torch.data.prefetch import Prefetcher
from d3dp_tpu_torch.data.windowing import window_sequence

__all__ = ["UnchunkedGenerator", "Prefetcher", "window_sequence"]

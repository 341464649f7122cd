from d3dp_tpu_torch.data.generators import ChunkedGenerator, UnchunkedGenerator
from d3dp_tpu_torch.data.prefetch import Prefetcher
from d3dp_tpu_torch.data.windowing import stitch_windows, window_batch, window_sequence

__all__ = ["ChunkedGenerator", "UnchunkedGenerator", "Prefetcher", "stitch_windows", "window_batch",
           "window_sequence"]

from d3dp_tpu_torch.data.generators import ChunkedGenerator, UnchunkedGenerator
from d3dp_tpu_torch.data.prefetch import Prefetcher
from d3dp_tpu_torch.data.windowing import (sample_windows, stitch_hypotheses, stitch_windows,
                                           window_batch, window_sequence)

__all__ = ["ChunkedGenerator", "UnchunkedGenerator", "Prefetcher", "sample_windows",
           "stitch_hypotheses", "stitch_windows", "window_batch", "window_sequence"]

"""Background-thread prefetcher: overlap host batch assembly with device
compute.

The reference feeds the GPU synchronously (main.py:364-380). Here a worker
thread runs the generator and stages its results a few items ahead, so the
device does not wait on the host's numpy work.
"""

import queue
import threading

from d3dp_tpu_torch.utils import profiling


class _Stop:
    pass


class Prefetcher:
    """Iterate `iterable` in a worker thread, at most `depth` items ahead.
    `to_device` (optional) maps each item in the worker, e.g. a data-parallel
    rank's placement of its rows (`parallel.shard_batch_fn`). An exception
    raised by the iterable is re-raised in the consumer."""

    def __init__(self, iterable, to_device=None, depth=2):
        self.iterable = iterable
        self.to_device = to_device or (lambda x: x)
        self.depth = depth

    def __iter__(self):
        q = queue.Queue(maxsize=self.depth)
        err = []
        stop = threading.Event()

        def worker():
            try:
                for item in self.iterable:
                    item = self.to_device(item)
                    while not stop.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
            except BaseException as e:  # surface worker errors in the consumer
                err.append(e)
            finally:
                q.put(_Stop)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                # the consumer's wait; a get that finds the queue empty is
                # one the producer did not keep ahead of
                with profiling.span("prefetch.wait"):
                    try:
                        item, starved = q.get_nowait(), 0
                    except queue.Empty:
                        item, starved = q.get(), 1
                if item is _Stop:
                    break
                profiling.count("prefetch.gets")
                if starved:
                    profiling.count("prefetch.starved")
                yield item
        finally:
            # consumer stopped (break / exception / GC): release the worker
            # and drop any staged items
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5)
        if err:
            raise err[0]

"""Observability: stdout tee and optional TensorBoard scalars.

Counterpart of d3dp_tpu/utils/logging.py (reference: common/logging.py and
the SummaryWriter use in main.py:55-61, :521-527).
"""

import importlib
import sys
import warnings


class Logger:
    """Tee stdout to a log file. (reference: common/logging.py:3-13)"""

    def __init__(self, path, stream=None):
        self.terminal = stream or sys.stdout
        self.log = open(path, "a")

    def write(self, message):
        self.terminal.write(message)
        self.log.write(message)
        self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()


class TensorBoardWriter:
    """Lazy SummaryWriter wrapper.

    Backends, in order: torch's SummaryWriter, then tensorboardX. When
    neither imports, the writer does nothing, with a visible warning, so a
    machine without them does not silently lose all scalar logging."""

    def __init__(self, logdir, enabled=True):
        self._writer = None
        if not enabled:
            return
        for modname in ("torch.utils.tensorboard", "tensorboardX"):
            try:
                self._writer = importlib.import_module(modname).SummaryWriter(logdir)
                return
            except Exception:  # a backend that fails to import or start is skipped
                continue
        warnings.warn(
            "TensorBoardWriter: no backend available (tried torch's "
            "SummaryWriter and tensorboardX) -- scalar logging is disabled. "
            "Install tensorboardX for torch-free logging, or pass --nolog "
            "to silence this.")

    def add_scalar(self, tag, value, step):
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def add_text(self, tag, text):
        if self._writer is not None:
            self._writer.add_text(tag, text)

    def close(self):
        if self._writer is not None:
            self._writer.close()

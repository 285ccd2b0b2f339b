"""Logging for dragg_tpu_torch (a copy of dragg_tpu/logger.py).

Capability parity with the reference logger (dragg/logger.py:4-23): a named
logger with an optional per-name file handler and a custom ``PROG`` level 25,
level taken from the ``LOGLEVEL`` env var.  Unlike the reference we do not
unconditionally create ``<name>_logger.log`` files in the CWD — file handlers
are opt-in via ``log_dir`` — and we never call ``logging.basicConfig`` (which
mutates global state).
"""

import logging
import os

PROG = 25
logging.addLevelName(PROG, "PROG")


def _progress(self, message, *args, **kws):
    if self.isEnabledFor(PROG):
        self._log(PROG, message, args, **kws)


logging.Logger.progress = _progress  # type: ignore[attr-defined]

_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


class Logger:
    """A named logger for simulation outputs.

    Parameters
    ----------
    name : str
        Logger name (e.g. ``"aggregator"``).
    log_dir : str | None
        If given, also log to ``<log_dir>/<name>.log``.
    """

    def __init__(self, name: str, log_dir: str | None = None):
        self.name = name
        self.logger = logging.getLogger(f"dragg_tpu_torch.{name}")
        self.logger.setLevel(os.environ.get("LOGLEVEL", "INFO"))
        if not self.logger.handlers:
            sh = logging.StreamHandler()
            sh.setFormatter(logging.Formatter(_FORMAT))
            self.logger.addHandler(sh)
            self.logger.propagate = False
        if log_dir is not None:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"{name}.log")
            if not any(
                isinstance(h, logging.FileHandler)
                and getattr(h, "baseFilename", None) == os.path.abspath(path)
                for h in self.logger.handlers
            ):
                fh = logging.FileHandler(path)
                fh.setFormatter(logging.Formatter(_FORMAT))
                self.logger.addHandler(fh)

    def __getattr__(self, item):
        return getattr(self.logger, item)

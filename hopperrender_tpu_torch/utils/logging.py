"""Structured logging: timestamped log file + console.

The PyTorch port's own copy of hopperrender_tpu/utils/logging.py (the port imports
nothing of the JAX package); tests/test_torch_control.py holds the two
to the same behaviour.

Equivalent of the reference's %TEMP%\\HopperRender_<timestamp>.log + debug console
output (ref: HopperRender.cpp:128-146,185-198). One logger per process; the file sink
is opt-in via enable_file_log() or HOPPERRENDER_TPU_LOG=1.
"""

from __future__ import annotations

import datetime
import logging
import os
import tempfile

_LOGGER_NAME = "hopperrender_tpu"
_file_handler: logging.Handler | None = None


def get_logger(child: str | None = None) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s")
        )
        logger.addHandler(handler)
        logger.setLevel(os.environ.get("HOPPERRENDER_TPU_LOGLEVEL", "INFO"))
        logger.propagate = False
        if os.environ.get("HOPPERRENDER_TPU_LOG"):
            enable_file_log()
    return logger.getChild(child) if child else logger


def enable_file_log(directory: str | None = None) -> str:
    """Open a timestamped log file (ref: HopperRender.cpp:185-198)."""
    global _file_handler
    logger = logging.getLogger(_LOGGER_NAME)
    if _file_handler is not None:
        return getattr(_file_handler, "baseFilename", "")
    directory = directory or tempfile.gettempdir()
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(directory, f"HopperRenderTPU_{ts}.log")
    _file_handler = logging.FileHandler(path)
    _file_handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)s [%(name)s] %(message)s")
    )
    logger.addHandler(_file_handler)
    return path

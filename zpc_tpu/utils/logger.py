"""Logging (reference ``Logger.hpp:14-29`` — plog rolling-file logger with
``ZS_LOG/ZS_WARN/ZS_ERROR`` macros).

Build: std-lib logging with an optional rolling file handler; module
-level convenience functions mirror the macro surface.
"""

from __future__ import annotations

import logging
import logging.handlers
import os
from typing import Optional

__all__ = ["get_logger", "log", "warn", "error", "enable_file_logging"]

_LOGGER: Optional[logging.Logger] = None


def get_logger() -> logging.Logger:
    global _LOGGER
    if _LOGGER is None:
        lg = logging.getLogger("zpc_tpu")
        if not lg.handlers:
            h = logging.StreamHandler()
            h.setFormatter(logging.Formatter(
                "[%(asctime)s %(levelname).1s %(name)s] %(message)s",
                "%H:%M:%S"))
            lg.addHandler(h)
            lg.setLevel(os.environ.get("ZPC_TPU_LOGLEVEL", "INFO"))
        _LOGGER = lg
    return _LOGGER


def enable_file_logging(path: str = "zpc_tpu.log",
                        max_bytes: int = 8 << 20, backups: int = 2):
    """Rolling-file sink (plog rolling ``zensim_logs.log`` analog)."""
    h = logging.handlers.RotatingFileHandler(path, maxBytes=max_bytes,
                                             backupCount=backups)
    h.setFormatter(logging.Formatter(
        "[%(asctime)s %(levelname).1s] %(message)s"))
    get_logger().addHandler(h)


def log(msg, *args):
    get_logger().info(msg, *args)


def warn(msg, *args):
    get_logger().warning(msg, *args)


def error(msg, *args):
    get_logger().error(msg, *args)

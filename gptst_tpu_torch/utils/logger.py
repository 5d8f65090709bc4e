"""Logging (counterpart of `lib/logger.py`): console always; optional
file handler when a log_dir is given and debug is off."""

from __future__ import annotations

import logging
import os


def get_logger(name: str, log_dir: str | None = None,
               debug: bool = True) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG if debug else logging.INFO)
    logger.propagate = False  # avoid double-printing via the root logger
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setFormatter(logging.Formatter("%(asctime)s: %(message)s"))
        logger.addHandler(console)
        if log_dir and not debug:
            os.makedirs(log_dir, exist_ok=True)
            fh = logging.FileHandler(os.path.join(log_dir, "run.log"))
            fh.setFormatter(logging.Formatter(
                "%(asctime)s - %(levelname)s - %(message)s"))
            logger.addHandler(fh)
    return logger

"""Logging to stderr and, when asked, to a file in a log directory — a copy
of lstc_vad_tpu/utils/logging.py:13-44 (the reference hardcodes its author's
absolute log paths, utils/utils.py:154-161)."""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional


def get_logger(name: str = "lstc", log_dir: Optional[str] = None,
               filename: Optional[str] = None,
               verbosity: int = 1) -> logging.Logger:
    """The logger ``name``, reconfigured: one stderr handler and, with
    ``log_dir``, one file handler (``filename``, by default the start time
    ``%Y%m%d-%H%M%S.log``).  ``verbosity`` 0/1/2: DEBUG/INFO/WARNING."""
    level = {0: logging.DEBUG, 1: logging.INFO, 2: logging.WARNING}[verbosity]
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    for h in logger.handlers:
        h.close()  # reconfiguring must not leak the old FileHandler's fd
    logger.handlers.clear()
    fmt = logging.Formatter("[%(asctime)s] %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        if filename is None:
            filename = time.strftime("%Y%m%d-%H%M%S") + ".log"
        fh = logging.FileHandler(os.path.join(log_dir, filename), "w")
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def log_config(logger: logging.Logger, cfg, prefix: str = ""):
    """Log every config field, one ``path<TAB>value`` line each (the
    reference's log_param, utils/utils.py:90-96)."""
    if dataclasses.is_dataclass(cfg):
        for f in dataclasses.fields(cfg):
            log_config(logger, getattr(cfg, f.name), f"{prefix}{f.name}.")
    else:
        logger.info("%s\t%s", prefix.rstrip("."), cfg)

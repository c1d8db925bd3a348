"""Logging, profiling, seeding and misc helpers (lstc_vad_tpu/utils/).
``utils.seeding`` and ``utils.misc`` import torch, so they are imported by
name: a torch-free serving worker imports this package's logging."""

from .logging import get_logger, log_config  # noqa: F401
from .profiling import annotate, trace  # noqa: F401

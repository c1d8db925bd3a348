"""Logging and profiling helpers (lstc_vad_tpu/utils/logging.py and
profiling.py); the seeding and misc helpers of the JAX package are ROADMAP
A19."""

from .logging import get_logger, log_config  # noqa: F401
from .profiling import StepTimer, annotate, trace  # noqa: F401

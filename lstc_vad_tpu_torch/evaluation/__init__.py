from .drivers import evaluate_ltn, evaluate_stn  # noqa: F401
from .metrics import roc_auc  # noqa: F401
from .scoring import ClipScorer, PartScorer, VideoScorer  # noqa: F401

from .drivers import (evaluate_ltn, evaluate_stn,  # noqa: F401
                      evaluate_ucf_ltn, evaluate_ucf_per_class,
                      evaluate_ucf_stn)
from .metrics import roc_auc  # noqa: F401
from .scoring import (ClipScorer, PartScorer,  # noqa: F401
                      UCFBinnedScorer, UCFClipBinScorer, VideoScorer,
                      ucf_final_eval_scorer, ucf_final_eval_shapes)

from .drivers import (evaluate_ltn, evaluate_multicrop_mean,  # noqa: F401
                      evaluate_stn,
                      evaluate_ucf_ltn, evaluate_ucf_per_class,
                      evaluate_ucf_stn)
from .metrics import roc_auc  # noqa: F401
from .scoring import (ArtifactVideoScorer, ClipScorer,  # noqa: F401
                      PartScorer,
                      UCFBinnedScorer, UCFClipBinScorer, VideoScorer,
                      ucf_final_eval_scorer, ucf_final_eval_shapes)

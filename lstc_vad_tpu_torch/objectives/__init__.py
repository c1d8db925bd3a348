from .losses import (  # noqa: F401
    build_clip_labels,
    coteach_stn_mil_loss,
    ltn_mil_loss,
    mil_ranking_loss,
    soft_cross_entropy_on_probs,
    soft_labels_from_pseudo,
    stn_mil_loss,
    weighted_bce,
)

from .coteach import CoTeachingDriver  # noqa: F401
from .generator import (  # noqa: F401
    generate_ltn_pseudo_labels,
    generate_stn_pseudo_labels,
    pseudo_scorer,
    save_pseudo_labels,
)

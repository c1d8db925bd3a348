from .datasets import TestVideo, load_test_videos  # noqa: F401
from .feature_store import FeatureStore  # noqa: F401

from .datasets import (  # noqa: F401
    PairedTrainDataset,
    TestVideo,
    load_pseudo_labels,
    load_test_videos,
    load_train_records,
)
from .feature_store import FeatureStore  # noqa: F401
from .packed import PackedStore  # noqa: F401
from .pipeline import BatchIterator, Prefetcher  # noqa: F401

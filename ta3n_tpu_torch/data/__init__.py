"""Data of the port: video records and class lists, the packed feature
store and its upload to the card, TSN samplers, the loader of feature and
index batches, and synthetic stores."""

from ta3n_tpu_torch.data.feature_store import FeatureStore
from ta3n_tpu_torch.data.loader import Batch, IndexBatch, TSNLoader
from ta3n_tpu_torch.data.manifest import (VideoRecord, epoch_balance_counts,
                                          load_class_names, repeat_to)
from ta3n_tpu_torch.data.synthetic import (make_domain_pair,
                                           make_synthetic_store)

__all__ = ["FeatureStore", "Batch", "IndexBatch", "TSNLoader",
           "VideoRecord", "epoch_balance_counts", "load_class_names",
           "repeat_to", "make_domain_pair", "make_synthetic_store"]

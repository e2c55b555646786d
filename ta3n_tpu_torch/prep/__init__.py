"""Data preparation of the port: the feature extractor
(`prep/video2feature.py`, videos to a packed FeatureStore on the card) and
the port's own copies of the JAX package's host tools: train/val
splitting (`dataset2split.py`), list manifests (`video_dataset2list.py`),
DA class-subset filtering (`list2da.py`) and frame counts and overlays
(`video_processing.py`, cv2 imported only in its functions).  The
`.t7`-per-frame converter is `cli/convert_features.py`."""

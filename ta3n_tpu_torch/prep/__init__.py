"""Data preparation of the port: the feature extractor
(`prep/video2feature.py`), videos to a packed FeatureStore on the card.
The JAX package's other prep tools need no accelerator and are not
ported yet (ROADMAP.md queue 1, item 12)."""

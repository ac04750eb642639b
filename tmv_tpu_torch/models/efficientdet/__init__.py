"""EfficientDet D0–D7x (EfficientNet backbone, BiFPN, heads) and its predict harness."""

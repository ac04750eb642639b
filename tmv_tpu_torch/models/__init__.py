"""Model zoo (so far: YOLOv4) and its predict harness."""

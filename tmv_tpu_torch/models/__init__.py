"""Model zoo (YOLOv4/v3, EfficientDet, UNet, FaceNet) and the detectors' predict harnesses."""

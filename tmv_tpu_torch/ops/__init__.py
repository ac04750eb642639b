"""Box, IoU, NMS and YOLO head ops on tensors."""

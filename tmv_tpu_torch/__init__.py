"""tmv_tpu_torch — the PyTorch/CUDA port of ``tmv_tpu``, for one NVIDIA H100.

It mirrors ``tmv_tpu``'s layout and module names and keeps its layouts at the
public functions: images NHWC ``(B, H, W, 3)`` float in [0, 1], heads
``(B, h, w, A*(5+C))``, boxes as normalized xyxy. Inside, convolutions run NCHW in
``channels_last`` memory. The TPU's Pallas kernels become kernels written by hand
for Hopper (``kernels/``, sources in ``csrc/``).

Ported so far: the YOLOv4, YOLOv3, ResNetYoloV3 and EfficientDet-D0 predict
paths and their HTTP serving (``cli/serve.py``, ``serving/wsgi.py``) and
one-image detection (``cli/detect.py``), their training (``cli/train_yolo.py``
with mosaic, the staging cache and ``--remat``; ``cli/train_efficientdet.py``)
and mAP evaluation (``cli/eval_map.py``), the Darknet/Keras importers, the UNet
keypoint family's training (``cli/train_unet.py``), the FaceNet family's
embeddings, triplet mining and training (``cli/train_facenet.py``) and LFW
validation (``cli/validate_on_lfw.py``, ``cli/facenet_distance.py``), the flax weight and
optimizer-state bridge (``convert/flax_bridge.py``), the greedy-NMS kernel and
the fused depthwise-conv + BatchNorm + swish kernel.
The package imports ``torch``, numpy, PIL and the standard library, and nothing
of ``jax``, ``flax`` or the ``tmv_tpu`` package: where it needs a jax-free module
of ``tmv_tpu`` (config, loaders, samplers, stage cache, map_eval, image and file
helpers, serving, the FaceNet dataset and LFW evaluation), it keeps its own copy.
"""

__version__ = "0.1.0"

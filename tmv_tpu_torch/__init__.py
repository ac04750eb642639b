"""tmv_tpu_torch — the PyTorch/CUDA port of ``tmv_tpu``, for one NVIDIA H100.

It mirrors ``tmv_tpu``'s layout and module names and keeps its layouts at the
public functions: images NHWC ``(B, H, W, 3)`` float in [0, 1], heads
``(B, h, w, A*(5+C))``, boxes as normalized xyxy. Inside, convolutions run NCHW in
``channels_last`` memory. The TPU's Pallas kernels become kernels written by hand
for Hopper (``kernels/``, sources in ``csrc/``).

Ported so far: the YOLOv4 predict path and its HTTP serving (``cli/serve.py``),
the flax weight bridge (``convert/flax_bridge.py``) and the greedy-NMS kernel.
The package imports ``torch`` and never ``jax``; it reuses the jax-free modules of
``tmv_tpu`` (``serving.app``, ``serving.batching``, ``data.loaders``, ``utils``).
"""

__version__ = "0.1.0"

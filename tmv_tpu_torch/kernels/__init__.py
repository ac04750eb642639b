"""Hand-written Hopper kernels (sources in ``tmv_tpu_torch/csrc``)."""

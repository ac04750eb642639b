"""int8 serving: dynamic (``dynamic.py``) and static-calibration (``static.py``)."""

from tmv_tpu_torch.quant.dynamic import (  # noqa: F401
    dynamic_int8_conv,
    quant_mode,
    quantized,
)
from tmv_tpu_torch.quant.static import (  # noqa: F401
    calibrate_absmax,
    calibrate_model,
    prepare_static_int8,
    static_int8_conv,
)

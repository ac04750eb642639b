"""Detection visualization and image summaries (the port's copy of
``tmv_tpu/visualize``)."""

from tmv_tpu_torch.visualize.vis_utils import (  # noqa: F401
    STANDARD_COLORS,
    draw_bounding_box_on_image_array,
    draw_bounding_boxes_on_image_array,
    draw_keypoints_on_image_array,
    draw_mask_on_image_array,
    visualize_boxes_and_labels_on_image_array,
)
from tmv_tpu_torch.visualize.summaries import (  # noqa: F401
    EvalVisualization,
    cdf_image,
    draw_side_by_side_evaluation_image,
    encode_image_array_as_png_str,
    hist_image,
    save_image_array_as_png,
)

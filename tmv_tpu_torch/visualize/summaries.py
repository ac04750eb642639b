"""Array-mode image summaries: CDF/histogram plots, side-by-side eval

The port's own copy of ``tmv_tpu/visualize/summaries.py`` (PIL and numpy;
``cdf_image`` and ``hist_image`` import matplotlib when called).
images, and the evaluation-visualization accumulator.

Capability parity with the TF-summary half of the reference's vendored
visualization library (`AIServer/ai_api/ai_models/visualize/vis_utils.py`):

- ``save_image_array_as_png`` / ``encode_image_array_as_png_str``
  (`vis_utils.py:95-121`) — PIL, unchanged semantics.
- ``cdf_image`` / ``hist_image`` — the numpy plot bodies of
  ``add_cdf_image_summary`` / ``add_hist_image_summary``
  (`vis_utils.py:916-979`) returning ``(1, H, W, 3) uint8`` arrays.  The
  ``tf.py_func``+``tf.summary.image`` wrappers are TF-estimator plumbing;
  the TPU-native stack logs arrays through the JSONL metrics sink or
  writes PNGs directly.
- ``draw_side_by_side_evaluation_image`` (`vis_utils.py:502-644`) —
  detections panel | ground-truth panel, array in/array out (the
  reference's version consumes a TF ``eval_dict``; here the fields are
  explicit arguments).
- ``EvalVisualization`` (`vis_utils.py:981-1155`,
  ``EvalMetricOpsVisualization``/``VisualizeSingleFrameDetections``) —
  re-designed from TF ``eval_metric_ops`` machinery to a plain
  accumulator: accrue up to ``max_examples_to_draw`` rendered eval images,
  drain them for logging, ``clear()`` between epochs.
"""

import io
from typing import Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from tmv_tpu_torch.visualize.vis_utils import (
    visualize_boxes_and_labels_on_image_array,
)


def save_image_array_as_png(image: np.ndarray, output_path: str):
    """`vis_utils.py:95-105`: uint8 (H, W, 3) array → PNG file."""
    Image.fromarray(np.uint8(image)).convert("RGB").save(
        output_path, format="PNG")


def encode_image_array_as_png_str(image: np.ndarray) -> bytes:
    """`vis_utils.py:107-121`: uint8 array → PNG bytes."""
    buf = io.BytesIO()
    Image.fromarray(np.uint8(image)).convert("RGB").save(buf, format="PNG")
    return buf.getvalue()


def _figure_to_array(fig) -> np.ndarray:
    fig.canvas.draw()
    w, h = fig.canvas.get_width_height()
    buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
    image = buf.reshape(int(h), int(w), 4)[..., :3]
    return image[None]


def cdf_image(values: np.ndarray) -> np.ndarray:
    """CDF plot of ``values`` → (1, H, W, 3) uint8
    (`vis_utils.py:927-945` plot body: normalize to sum 1, sort, cumsum
    vs fraction-of-examples)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    values = np.asarray(values, np.float32).reshape(-1)
    normalized = values / np.sum(values)
    cumulative = np.cumsum(np.sort(normalized))
    fraction = np.arange(cumulative.size, dtype=np.float32) / cumulative.size
    fig = plt.figure(frameon=False)
    ax = fig.add_subplot(111)
    ax.plot(fraction, cumulative)
    ax.set_ylabel("cumulative normalized values")
    ax.set_xlabel("fraction of examples")
    out = _figure_to_array(fig)
    plt.close(fig)
    return out


def hist_image(values: np.ndarray, bins) -> np.ndarray:
    """Histogram plot of ``values`` → (1, H, W, 3) uint8
    (`vis_utils.py:962-975` plot body)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    values = np.asarray(values, np.float32).reshape(-1)
    y, x = np.histogram(values, bins=bins)
    fig = plt.figure(frameon=False)
    ax = fig.add_subplot(111)
    ax.plot(x[:-1], y)
    ax.set_ylabel("count")
    ax.set_xlabel("value")
    out = _figure_to_array(fig)
    plt.close(fig)
    return out


def draw_side_by_side_evaluation_image(
    image: np.ndarray,
    detection_boxes: np.ndarray,
    detection_classes: Sequence[int],
    detection_scores: Sequence[float],
    groundtruth_boxes: np.ndarray,
    groundtruth_classes: Sequence[int],
    category_index: Dict[int, Dict],
    max_boxes_to_draw: int = 20,
    min_score_thresh: float = 0.2,
    use_normalized_coordinates: bool = True,
) -> np.ndarray:
    """(H, W, 3) image → (H, 2·W, 3): detections left, ground truth right
    (`vis_utils.py:502-644`, eval-dict plumbing replaced by explicit
    array arguments)."""
    left = visualize_boxes_and_labels_on_image_array(
        np.array(image, np.uint8, copy=True),
        np.asarray(detection_boxes),
        detection_classes,
        detection_scores,
        category_index,
        use_normalized_coordinates=use_normalized_coordinates,
        max_boxes_to_draw=max_boxes_to_draw,
        min_score_thresh=min_score_thresh,
    )
    right = visualize_boxes_and_labels_on_image_array(
        np.array(image, np.uint8, copy=True),
        np.asarray(groundtruth_boxes),
        groundtruth_classes,
        None,  # GT has no scores → black boxes, like the reference
        category_index,
        use_normalized_coordinates=use_normalized_coordinates,
        max_boxes_to_draw=None,
        min_score_thresh=0.0,
    )
    return np.concatenate([left, right], axis=1)


class EvalVisualization:
    """Accrue up to ``max_examples_to_draw`` rendered eval images.

    The reference's ``EvalMetricOpsVisualization`` accrues TF image
    summaries through ``eval_metric_ops`` update/value ops
    (`vis_utils.py:981-1127`); the TPU-native version is a plain
    accumulator — call :meth:`add_example` per evaluated image, drain
    :meth:`images` (or write PNGs with :meth:`save`) at epoch end, then
    :meth:`clear` (the reference clears inside its value op,
    `vis_utils.py:1045-1050`)."""

    def __init__(self, category_index: Dict[int, Dict],
                 max_examples_to_draw: int = 5,
                 max_boxes_to_draw: int = 20,
                 min_score_thresh: float = 0.2,
                 use_normalized_coordinates: bool = True,
                 summary_name_prefix: str = "evaluation_image"):
        self.category_index = category_index
        self.max_examples_to_draw = max_examples_to_draw
        self.max_boxes_to_draw = max_boxes_to_draw
        self.min_score_thresh = min_score_thresh
        self.use_normalized_coordinates = use_normalized_coordinates
        self.summary_name_prefix = summary_name_prefix
        self._images: List[np.ndarray] = []

    def add_example(self, image, detection_boxes, detection_classes,
                    detection_scores, groundtruth_boxes,
                    groundtruth_classes) -> bool:
        """Render + accrue one example; returns False once full
        (mirrors the `len(self._images) >= max` cutoff at
        `vis_utils.py:1100-1105`)."""
        if len(self._images) >= self.max_examples_to_draw:
            return False
        self._images.append(draw_side_by_side_evaluation_image(
            image, detection_boxes, detection_classes, detection_scores,
            groundtruth_boxes, groundtruth_classes, self.category_index,
            self.max_boxes_to_draw, self.min_score_thresh,
            self.use_normalized_coordinates))
        return True

    def images(self) -> List[np.ndarray]:
        return list(self._images)

    def save(self, directory: str) -> List[str]:
        import os

        os.makedirs(directory, exist_ok=True)
        paths = []
        for i, img in enumerate(self._images):
            p = os.path.join(directory,
                             f"{self.summary_name_prefix}_{i}.png")
            save_image_array_as_png(img, p)
            paths.append(p)
        return paths

    def clear(self):
        self._images = []

"""The port's shared pieces against the JAX package's, on the CPU.

- ``ops/nms.py::soft_nms`` on clustered boxes with tied scores and padding, both
  coordinate conventions: JAX's indices and valid mask exactly, its scores
  within 1e-6 (float32 Gaussian decays compound over the picks).
- ``ops/regularizers.py``: ``drop_block`` fed JAX's draws (permuted to NCHW)
  equals JAX's output exactly (a 0/1 mask times x); ``disout`` and
  ``disout_1d`` within 1e-6·max|ref| (float32 sums over channels and pixels
  in another order); block edges odd and even, the reference's shrinking of
  the block on small maps; eval mode is the identity. ``drop_connect`` lives
  here and EfficientDet's heads use this one.
- ``models/layers/attention_conv.py``: ``AttentionConv2D`` (stride 1 and 2,
  with and without bias) and ``SkipLayer`` (concat and add, two layers) by
  ``torch_port_cases.hold_against_flax``, through the bridge's names.
- ``ops/losses.py::smooth_l1_loss`` within 1e-7·max|ref|.
- ``utils``: ``kmeans_wh`` for a seed from a label file and from VOC XML,
  ``save_anchors_csv``, ``coco_to_labels``' two files byte for byte,
  ``read_dir_list`` and the label maps equal JAX's.
- ``visualize``: the drawn pixel arrays (boxes with labels, keypoints, masks,
  the orchestration in class and agnostic modes, the side-by-side evaluation
  image, ``EvalVisualization``'s images and PNG files, the PNG encoders) and
  matplotlib's CDF and histogram images equal JAX's.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tmv_tpu.visualize as jax_vis
from tmv_tpu.models.layers import attention_conv as jax_attention
from tmv_tpu.ops import regularizers as jax_reg
from tmv_tpu.ops.losses import smooth_l1_loss as jax_smooth_l1
from tmv_tpu.ops.nms import soft_nms as jax_soft_nms
from tmv_tpu.utils import coco_convert as jax_coco
from tmv_tpu.utils import file_helper as jax_files
from tmv_tpu.utils import kmeans_anchors as jax_kmeans
from tmv_tpu.utils import label_util as jax_labels
import tmv_tpu_torch.visualize as vis
from tmv_tpu_torch.models.efficientdet import heads
from tmv_tpu_torch.models.layers.attention_conv import AttentionConv2D, SkipLayer
from tmv_tpu_torch.ops import regularizers as reg
from tmv_tpu_torch.ops.losses import smooth_l1_loss
from tmv_tpu_torch.ops.nms import soft_nms
from tmv_tpu_torch.utils import coco_convert, file_helper, kmeans_anchors, label_util
from torch_port_cases import hold_against_flax, nms_case
from torch_port_cases import one_torch_thread  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("coord", ["xyxy", "yxyx"])
def test_soft_nms_equals_jax(coord):
    rng = np.random.default_rng(3 if coord == "xyxy" else 4)
    boxes, scores, _, valid = nms_case(rng, 64)
    if coord == "yxyx":
        boxes = boxes[:, [1, 0, 3, 2]]
    want = [np.asarray(t) for t in jax_soft_nms(jnp.asarray(boxes), jnp.asarray(scores),
                                                jnp.asarray(valid), max_output_size=64,
                                                sigma=0.5, score_threshold=0.05, coord=coord)]
    got = [t.numpy() for t in soft_nms(torch.from_numpy(boxes), torch.from_numpy(scores),
                                       torch.from_numpy(valid), max_output_size=64, sigma=0.5,
                                       score_threshold=0.05, coord=coord)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    assert 0 < want[2].sum() < 64          # padding and the threshold end the picks


def nchw(a):
    return torch.from_numpy(np.array(a).transpose(0, 3, 1, 2).copy())


# (NHWC shape, block_size, dist_prob): bs 5; bs shrunk to 3 (h // 5 = 2); bs 2 (even)
BLOCK_CASES = [((2, 30, 28, 4), 5, 0.1), ((2, 12, 10, 3), 5, 0.3), ((1, 8, 9, 2), 5, 0.5)]


@pytest.mark.parametrize("shape,block_size,dist_prob", BLOCK_CASES)
def test_drop_block_and_disout_with_jax_draws(shape, block_size, dist_prob):
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32)
    key = jax.random.key(shape[1])
    b, h, w, c = shape
    bs = reg.block_size_of(h, block_size)
    want = np.asarray(jax_reg.drop_block(jnp.asarray(x), key, True, dist_prob, block_size))
    centers = jax.random.uniform(key, (b, h - bs + 1, w - bs + 1, c))
    got = reg.drop_block(nchw(x), True, dist_prob, nchw(centers), block_size)
    assert reg.center_shape(nchw(x), block_size) == tuple(nchw(centers).shape)
    np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    assert 0 < (want == 0).mean() < 1

    want = np.asarray(jax_reg.disout(jnp.asarray(x), key, True, dist_prob, block_size))
    k_mask, k_noise = jax.random.split(key)
    centers = jax.random.uniform(k_mask, (b, h - bs + 1, w - bs + 1, c))
    noise = jax.random.uniform(k_noise, shape)
    got = reg.disout(nchw(x), True, dist_prob, nchw(centers), nchw(noise), block_size)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    assert not np.array_equal(want, x)
    for fn in (lambda t: reg.drop_block(t, False, dist_prob, None),
               lambda t: reg.disout(t, False, dist_prob, None, None)):
        assert fn(nchw(x)) is not None and torch.equal(fn(nchw(x)), nchw(x))


@pytest.mark.parametrize("shape,block_size", [((3, 20), 5), ((2, 9), 4)])
def test_disout_1d_with_jax_draws(shape, block_size):
    rng = np.random.default_rng(shape[1])
    x = rng.normal(size=shape).astype(np.float32)
    key = jax.random.key(shape[1])
    want = np.asarray(jax_reg.disout_1d(jnp.asarray(x), key, True, 0.2, block_size))
    k_mask, k_noise = jax.random.split(key)
    centers = jax.random.uniform(k_mask, (shape[0], shape[1] - block_size + 1))
    noise = jax.random.uniform(k_noise, shape)
    got = reg.disout_1d(torch.from_numpy(x), True, 0.2, torch.from_numpy(np.array(centers)),
                        torch.from_numpy(np.array(noise)), block_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())
    assert not np.array_equal(want, x)
    assert heads.drop_connect is reg.drop_connect


@pytest.mark.parametrize("filters,kernel,strides,use_bias,shape", [
    (6, 3, 1, False, (2, 8, 8, 4)), (5, (3, 1), 2, True, (2, 9, 7, 4))])
def test_attention_conv_matches_flax(filters, kernel, strides, use_bias, shape):
    flax_module = jax_attention.AttentionConv2D(filters, kernel, (strides, strides), use_bias)
    hold_against_flax(flax_module, AttentionConv2D(shape[-1], filters, kernel, strides,
                                                   use_bias), shape, seed=filters)


@pytest.mark.parametrize("merge", ["concat", "add"])
def test_skip_layer_matches_flax(merge):
    width = 4 if merge == "add" else 5

    def flax_skip(dtype):
        return jax_attention.SkipLayer((jax_attention.AttentionConv2D(6, 3, dtype=dtype),
                                        jax_attention.AttentionConv2D(width, 1, dtype=dtype)),
                                       merge)

    torch_skip = SkipLayer([AttentionConv2D(4, 6, 3), AttentionConv2D(6, width, 1)], merge)
    hold_against_flax(flax_skip(jnp.float32), torch_skip, (2, 8, 8, 4),
                      flax_module64=flax_skip(jnp.float64))


def test_smooth_l1_loss_equals_jax():
    rng = np.random.default_rng(0)
    y_true = rng.normal(size=(4, 30)).astype(np.float32)
    y_pred = (y_true + rng.normal(0, 0.6, size=(4, 30))).astype(np.float32)
    for beta in (0.5, 1.0):
        want = np.asarray(jax_smooth_l1(jnp.asarray(y_true), jnp.asarray(y_pred), beta))
        got = smooth_l1_loss(torch.from_numpy(y_true), torch.from_numpy(y_pred), beta).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * np.abs(want).max())


def test_utils_equal_jax(tmp_path):
    rng = np.random.default_rng(8)
    lines = []
    for i in range(30):
        parts = [f"im{i}.jpg"]
        for _ in range(3):
            x1, y1 = rng.uniform(0, 300, 2)
            w, h = rng.uniform(5, 200, 2)
            parts.append(f"c{i % 3},{x1:.1f},{y1:.1f},{x1 + w:.1f},{y1 + h:.1f}")
        lines.append("|".join(parts) + "|")
    (tmp_path / "labels.txt").write_text("\n".join(lines) + "\n")
    (tmp_path / "xml").mkdir()
    for i in range(4):
        objs = "".join(
            f"<object><bndbox><xmin>{a}</xmin><ymin>{b}</ymin><xmax>{a + w}</xmax>"
            f"<ymax>{b + h}</ymax></bndbox></object>"
            for a, b, w, h in rng.integers(1, 120, (5, 4)))
        (tmp_path / "xml" / f"a{i}.xml").write_text(f"<annotation>{objs}</annotation>")
    for source in ("labels", "xml"):
        if source == "labels":
            whs = kmeans_anchors.boxes_from_labels_file(str(tmp_path / "labels.txt"))
            want_whs = jax_kmeans.boxes_from_labels_file(str(tmp_path / "labels.txt"))
        else:
            whs = kmeans_anchors.boxes_from_voc_xml(str(tmp_path / "xml"))
            want_whs = jax_kmeans.boxes_from_voc_xml(str(tmp_path / "xml"))
        np.testing.assert_array_equal(whs, want_whs)
        got, want = kmeans_anchors.kmeans_wh(whs, 9, seed=2), jax_kmeans.kmeans_wh(whs, 9, seed=2)
        np.testing.assert_array_equal(got, want)
        kmeans_anchors.save_anchors_csv(got, str(tmp_path / "a.txt"))
        jax_kmeans.save_anchors_csv(want, str(tmp_path / "b.txt"))
        assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()

    coco = {"categories": [{"id": 3, "name": "car"}, {"id": 1, "name": "person"}],
            "images": [{"id": 7, "file_name": "a.jpg"}, {"id": 9, "file_name": "b.jpg"}],
            "annotations": [{"image_id": 7, "category_id": 1, "bbox": [1.5, 2, 10, 20]},
                            {"image_id": 7, "category_id": 3, "bbox": [5, 6, 7, 8.25]},
                            {"image_id": 9, "category_id": 3, "bbox": [0, 0, 3, 3],
                             "iscrowd": 1}]}
    (tmp_path / "ann.json").write_text(json.dumps(coco))
    got = coco_convert.coco_to_labels(str(tmp_path / "ann.json"), str(tmp_path / "port"), "val")
    want = jax_coco.coco_to_labels(str(tmp_path / "ann.json"), str(tmp_path / "jax"), "val")
    for g, w in zip(got, want):
        assert os.path.basename(g) == os.path.basename(w)
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()

    for d in ("b_dir", "a_dir", "skip"):
        (tmp_path / "tree" / d).mkdir(parents=True)
    (tmp_path / "tree" / "file_dir").write_text("")
    for pattern in (None, r"_dir$"):
        assert (file_helper.read_dir_list(str(tmp_path / "tree"), pattern)
                == jax_files.read_dir_list(str(tmp_path / "tree"), pattern))
    assert file_helper.read_dir_list(str(tmp_path / "tree"), r"_dir$")[0].endswith("a_dir")
    for name in ("coco", "voc"):
        assert label_util.get_label_map(name) == jax_labels.get_label_map(name)


def drawn(module):
    """The images each visualize function draws, by the functions of ``module``."""
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    boxes = np.array([[0.1, 0.1, 0.5, 0.5], [0.3, 0.2, 0.9, 0.7], [0.6, 0.6, 0.95, 0.9]])
    cats = {1: {"name": "cat"}, 2: {"name": "dog"}}
    out = {}
    img = base.copy()
    module.draw_bounding_box_on_image_array(img, 5, 6, 40, 50, "Red", 3, ["a: 1%", "b"], False)
    out["box"] = img
    img = base.copy()
    module.draw_bounding_boxes_on_image_array(img, boxes, "Blue", 2, [["x"], ["y"]])
    out["boxes"] = img
    img = base.copy()
    module.draw_keypoints_on_image_array(img, [(0.5, 0.5), (0.2, 0.7)], "Lime", 3)
    out["keypoints"] = img
    img = base.copy()
    module.draw_mask_on_image_array(img, rng.integers(0, 2, (64, 80)), "Gold", 0.3)
    out["mask"] = img
    masks = [rng.integers(0, 2, (64, 80)) for _ in range(3)]
    for agnostic in (False, True):
        out[f"orchestration {agnostic}"] = module.visualize_boxes_and_labels_on_image_array(
            base.copy(), boxes, [1, 2, 1], [0.9, 0.6, 0.3], cats, instance_masks=masks,
            keypoints=[[(0.2, 0.2)], [(0.5, 0.4)], [(0.7, 0.7)]],
            use_normalized_coordinates=True, min_score_thresh=0.5, agnostic_mode=agnostic)
    out["side by side"] = module.draw_side_by_side_evaluation_image(
        base, boxes[:2], [1, 2], [0.9, 0.8], boxes[1:], [2, 1], cats)
    evals = module.EvalVisualization(cats, max_examples_to_draw=2)
    for _ in range(3):
        evals.add_example(base, boxes, [1, 2, 1], [0.9, 0.6, 0.3], boxes[:1], [1])
    for i, image in enumerate(evals.images()):
        out[f"eval {i}"] = image
    out["png"] = np.frombuffer(module.encode_image_array_as_png_str(base), np.uint8)
    values = rng.uniform(0, 1, 200).astype(np.float32)
    out["cdf"] = module.cdf_image(values)
    out["hist"] = module.hist_image(values, bins=np.linspace(0, 1, 11))
    return out, evals


def test_visualize_draws_jax_pixels(tmp_path):
    got, got_evals = drawn(vis)
    want, want_evals = drawn(jax_vis)
    assert got.keys() == want.keys()
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert (got["box"] != got["orchestration False"]).any()
    for g, w in zip(got_evals.save(str(tmp_path / "port")), want_evals.save(str(tmp_path / "jax"))):
        with open(g, "rb") as fg, open(w, "rb") as fw:
            assert fg.read() == fw.read()

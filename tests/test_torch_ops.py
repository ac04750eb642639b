"""The port's ops (tmv_tpu_torch.ops) against the JAX package's, on the CPU.

Same seeded numpy inputs through both. Tolerances: activations and IoU agree to
float32 rounding of different elementwise libraries (rtol 1e-5, atol 1e-6; NaN
where both are NaN). NMS index lists and valid masks must be exactly equal;
decoded boxes and scores agree to rtol 1e-5 / atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.ops import activations as jact
from tmv_tpu.ops.iou import iou_xyxy as j_iou_xyxy, iou_yxyx as j_iou_yxyx
from tmv_tpu.ops.nms import nms as j_nms, nms_by_classes as j_nms_by_classes
from tmv_tpu.ops.yolo import decode_boxes as j_decode, nms_boxes as j_nms_boxes
from tmv_tpu_torch.ops import activations as tact
from tmv_tpu_torch.ops.iou import iou_xyxy, iou_yxyx
from tmv_tpu_torch.ops.nms import nms, nms_by_classes
from tmv_tpu_torch.ops.yolo import decode_boxes, nms_boxes, nms_boxes_batched
from torch_port_cases import nms_case

T = torch.from_numpy
ANCHORS = np.array([[[116, 90], [156, 198], [373, 326]],
                    [[30, 61], [62, 45], [59, 119]],
                    [[10, 13], [16, 30], [33, 23]]], np.float32)


def close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               equal_nan=True)


@pytest.mark.parametrize("name", ["mish", "swish", "leaky_relu"])
def test_activations_match_jax(rng, name):
    x = np.concatenate([rng.normal(0, 4, 4096), [-100.0, -30.0, 0.0, 30.0, 100.0]])
    x = x.astype(np.float32)
    close(getattr(tact, name)(T(x)), getattr(jact, name)(jnp.asarray(x)))


def degenerate_boxes(rng, n, coord):
    """Random boxes plus zero-area, inverted and identical ones."""
    lo = rng.uniform(0, 50, (n, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(0, 30, (n, 2))], -1)
    boxes[0, 2:] = boxes[0, :2]                  # zero area (a point)
    boxes[1, 2] = boxes[1, 0]                    # zero width
    boxes[2, 2:] = boxes[2, :2] - 5.0            # inverted
    boxes[3] = boxes[4]                          # identical pair
    boxes = boxes.astype(np.float32)
    return boxes[:, [1, 0, 3, 2]] if coord == "yxyx" else boxes


@pytest.mark.parametrize("coord", ["xyxy", "yxyx"])
@pytest.mark.parametrize("iou_type", ["iou", "diou"])
def test_iou_matches_jax(rng, coord, iou_type):
    b1 = degenerate_boxes(rng, 40, coord)[:, None, :]
    b2 = degenerate_boxes(rng, 40, coord)[None, :, :]
    b2[0, :8] = b1[:8, 0]                        # include exact self-pairs
    jfn, tfn = (j_iou_xyxy, iou_xyxy) if coord == "xyxy" else (j_iou_yxyx, iou_yxyx)
    want = np.asarray(jfn(jnp.asarray(b1), jnp.asarray(b2), iou_type=iou_type))
    got = tfn(T(b1), T(b2), iou_type=iou_type).numpy()
    assert got.shape == want.shape == (40, 40)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    close(got, want)


def assert_same_selection(got, want):
    got_idx, got_valid = (np.asarray(g) for g in got)
    want_idx, want_valid = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got_valid, want_valid)
    np.testing.assert_array_equal(got_idx[got_valid], want_idx[want_valid])
    assert got_idx.dtype == np.int32


@pytest.mark.parametrize("class_aware", [False, True])
@pytest.mark.parametrize("coord", ["xyxy", "yxyx"])
@pytest.mark.parametrize("iou_type", ["iou", "diou"])
def test_nms_matches_jax(rng, class_aware, coord, iou_type):
    boxes, scores, classes, valid = nms_case(rng, 160)
    if coord == "yxyx":
        boxes = boxes[:, [1, 0, 3, 2]]
    kw = dict(max_output_size=40, iou_threshold=0.45, score_threshold=0.25,
              iou_type=iou_type, coord=coord)
    if class_aware:
        want = j_nms_by_classes(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                                jnp.asarray(valid), backend="xla", **kw)
        got = nms_by_classes(T(boxes), T(scores), T(classes), T(valid), **kw)
    else:
        want = j_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid),
                     backend="xla", **kw)
        got = nms(T(boxes), T(scores), T(valid), **kw)
    assert np.asarray(want[1]).sum() > 5
    assert_same_selection(got, want)


@pytest.mark.parametrize("cap", [1, 7, 500])
def test_nms_output_cap_and_ties(rng, cap):
    """All scores tied: order falls back to the input index, as in JAX."""
    boxes, _, _, _ = nms_case(rng, 128)
    scores = np.full(128, 0.5, np.float32)
    want = j_nms(jnp.asarray(boxes), jnp.asarray(scores), max_output_size=cap,
                 iou_type="diou", backend="xla")
    got = nms(T(boxes), T(scores), max_output_size=cap, iou_type="diou")
    assert_same_selection(got, want)
    assert got[0].shape == (cap,)


def test_nms_batched_matches_per_image(rng):
    cases = [nms_case(rng, 96) for _ in range(3)]
    boxes, scores, classes, valid = (np.stack(c) for c in zip(*cases))
    kw = dict(max_output_size=30, iou_threshold=0.5, iou_type="diou")
    got_idx, got_valid = nms_by_classes(T(boxes), T(scores), T(classes), T(valid), **kw)
    assert got_idx.shape == (3, 30)
    for b in range(3):
        want = j_nms_by_classes(jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                jnp.asarray(classes[b]), jnp.asarray(valid[b]),
                                backend="xla", **kw)
        assert_same_selection((got_idx[b], got_valid[b]), want)


def synthetic_heads(rng, image_size, classes_num, batch=None):
    """416-style raw heads on a coarse logit grid: saturated and tied class
    scores, overflowing widths, and more than 1024 candidates past the
    thresholds. Logits come from a small set of values, so that equal inputs
    give equal scores in both frameworks and distinct scores stay far apart."""
    heads = []
    for stride in (32, 16, 8):
        g = image_size // stride
        shape = ((batch,) if batch else ()) + (g, g, 3, 5 + classes_num)
        h = rng.choice(np.arange(-6.0, 6.5, 0.5), size=shape)
        h[..., 5:] = rng.choice([-4.0, -1.0, 0.5, 2.0, 40.0], size=shape[:-1] + (classes_num,),
                                p=[0.5, 0.2, 0.15, 0.1, 0.05])
        h[..., 2:4] = rng.choice([-1.0, -0.5, 0.0, 0.5, 100.0], size=shape[:-1] + (2,))
        h[..., 4] = rng.choice([-2.0, 1.0, 3.0, 40.0], size=shape[:-1])
        heads.append(h.reshape(shape[:-2] + (-1,)).astype(np.float32))
    return heads


def test_decode_boxes_matches_jax(rng):
    head = synthetic_heads(rng, 416, 80)[1].reshape(26, 26, 3, 85)
    anchors = ANCHORS[1] / 416.0
    want = j_decode(jnp.asarray(head), jnp.asarray(anchors), 80)
    got = decode_boxes(T(head), T(anchors), 80)
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.asarray(w).shape
        close(g, w)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert not got[3].all() and got[3].any()


@pytest.mark.parametrize("iou_type", ["iou", "diou"])
def test_nms_boxes_matches_jax_at_416(rng, iou_type):
    heads = synthetic_heads(rng, 416, 80)
    kw = dict(confidence_thresh=0.5, scores_thresh=0.2, iou_thresh=0.5, iou_type=iou_type)
    want = j_nms_boxes([jnp.asarray(h) for h in heads], jnp.asarray(ANCHORS), (416, 416), 80,
                       nms_backend="xla", **kw)
    got = nms_boxes([T(h) for h in heads], ANCHORS, (416, 416), 80, **kw)
    passing = 0
    for head, anchors in zip(heads, ANCHORS):
        g = head.shape[0]
        _, conf, cls, valid = decode_boxes(T(head).reshape(g, g, 3, 85), T(anchors) / 416.0, 80)
        passing += int((valid & (conf > 0.5) & (cls.amax(-1) > 0.2)).sum())
    assert passing > 1024                        # the pre-NMS cap is exercised
    w_boxes, w_ids, w_scores, _, _, w_valid = (np.asarray(w) for w in want)
    g_boxes, g_ids, g_scores, _, _, g_valid = (g.numpy() for g in got)
    np.testing.assert_array_equal(g_valid, w_valid)
    assert w_valid.sum() > 50
    np.testing.assert_array_equal(g_ids[g_valid], w_ids[w_valid])
    close(g_boxes[g_valid], w_boxes[w_valid])
    close(g_scores[g_valid], w_scores[w_valid])


def test_nms_boxes_decodes_bf16_heads_in_float32(rng):
    """bf16 heads (what the --bf16 forward gives) are decoded in float32: the
    port's result equals JAX's on the same heads widened to float32, exactly in
    valid masks, ids and scores. This is a deliberate departure from the JAX
    package, which decodes bf16 heads in bf16."""
    heads = [np.asarray(jnp.asarray(h, jnp.bfloat16), np.float32)
             for h in synthetic_heads(rng, 416, 80)]
    kw = dict(confidence_thresh=0.5, scores_thresh=0.2, iou_thresh=0.5, iou_type="diou")
    want = j_nms_boxes([jnp.asarray(h) for h in heads], jnp.asarray(ANCHORS), (416, 416), 80,
                       nms_backend="xla", **kw)
    got = nms_boxes([T(h).bfloat16() for h in heads], ANCHORS, (416, 416), 80, **kw)
    assert got[0].dtype == got[2].dtype == torch.float32
    w_valid, g_valid = np.asarray(want[5]), got[5].numpy()
    np.testing.assert_array_equal(g_valid, w_valid)
    assert w_valid.sum() > 50
    np.testing.assert_array_equal(got[1].numpy()[g_valid], np.asarray(want[1])[w_valid])
    close(got[0].numpy()[g_valid], np.asarray(want[0])[w_valid])
    np.testing.assert_array_equal(got[2].numpy()[g_valid], np.asarray(want[2])[w_valid])


def test_nms_boxes_batched_matches_jax(rng):
    heads = synthetic_heads(rng, 416, 80, batch=2)
    kw = dict(confidence_thresh=0.5, scores_thresh=0.2, iou_thresh=0.5, iou_type="diou")
    got = nms_boxes_batched([T(h) for h in heads], ANCHORS, (416, 416), 80, **kw)
    for b in range(2):
        want = j_nms_boxes([jnp.asarray(h[b]) for h in heads], jnp.asarray(ANCHORS),
                           (416, 416), 80, nms_backend="xla", **kw)
        w_valid, g_valid = np.asarray(want[5]), got[5][b].numpy()
        np.testing.assert_array_equal(g_valid, w_valid)
        np.testing.assert_array_equal(got[1][b].numpy()[g_valid], np.asarray(want[1])[w_valid])
        close(got[0][b].numpy()[g_valid], np.asarray(want[0])[w_valid])

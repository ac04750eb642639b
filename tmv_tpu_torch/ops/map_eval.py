"""mAP evaluation — the reference's quirky evaluator plus corrected variants.

The port's own copy of ``tmv_tpu/ops/map_eval.py`` (numpy, host side), which
matches `AIServer/ai_api/ai_models/utils/mAP.py:3-125`:

- ``get_ap``/``get_map``: the reference's AP, with its two quirks kept — the
  envelope variables swapped (``mrec`` from the precision list, ``mpre`` from
  the recall list, `utils/mAP.py:88-89`) and TP assignment by per-GT argmax over
  predictions (`:50-55`);
- ``get_ap_voc``: corrected VOC AP (proper axes, score-greedy matching);
- ``get_ap_coco``/``get_map_coco``: COCO AP@[.5:.95] with 101-point interpolation.

Every variant sorts predictions by score with a *stable* descending sort, so
equal-score rows keep their emission order; for the quirk AP the order is a
value-level no-op (it reduces to final recall × final precision).
"""

from typing import Dict, List, Sequence

import numpy as np


def _tp_and_count(data: Sequence[Dict], class_id: int, thresh: float):
    """Per-class TP flags + scores sorted by score desc, and GT count.

    Mirrors `utils/mAP.py:3-67` including per-GT argmax assignment.
    """
    tp_rows = []
    gt_num = 0
    for d in data:
        gt = np.asarray(d["groud_truth"], dtype=np.float64)
        gt = gt.reshape(-1, 5)
        gt = gt[gt[:, 4] == class_id]
        gt = gt[None, :, :]  # (1, G, 5)
        gt_num += gt.shape[1]
        pred = np.asarray(d["prediction"], dtype=np.float64)
        pred = pred.reshape(-1, 6)
        pred = pred[pred[:, 4] == class_id]
        pred = pred[:, None, :]  # (P, 1, 6)
        if gt.shape[1] == 0 or pred.shape[0] == 0:
            continue
        g_min, g_max = gt[..., 0:2], gt[..., 2:4]
        p_min, p_max = pred[..., 0:2], pred[..., 2:4]
        inter_wh = np.maximum(np.minimum(g_max, p_max) - np.maximum(g_min, p_min), 0.0)
        inter = inter_wh[..., 0] * inter_wh[..., 1]
        g_area = np.prod(g_max - g_min, axis=-1)
        p_area = np.prod(p_max - p_min, axis=-1)
        iou = inter / (g_area + p_area - inter)  # (P, G)
        tp_one = np.zeros((pred.shape[0],))
        best_pred = np.argmax(iou, axis=0)  # per-GT best prediction
        for g in range(best_pred.shape[0]):
            if iou[best_pred[g], g] >= thresh:
                tp_one[best_pred[g]] = 1
        tp_rows.append(np.stack([tp_one, pred[:, 0, 5]], axis=-1))
    if tp_rows:
        tp = np.concatenate(tp_rows, axis=0)
    else:
        tp = np.zeros((0, 2))
    # stable score-desc (ties keep emission order; see module docstring)
    tp = tp[np.argsort(-tp[:, 1], kind="stable"), :]
    return tp, gt_num


def _precision_recall(tp: np.ndarray, gt_num: int):
    precision_list, recall_list = [], []
    tp_sum = 0.0
    for i in range(tp.shape[0]):
        if tp[i][0] == 1:
            tp_sum += 1.0
        precision_list.append(tp_sum / (i + 1))
        recall_list.append(tp_sum / gt_num if gt_num else 0.0)
    return precision_list, recall_list


def _envelope_area(mrec: np.ndarray, mpre: np.ndarray) -> float:
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    i = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[i + 1] - mrec[i]) * mpre[i + 1]))


def get_ap(data: Sequence[Dict], class_id: int, thresh: float = 0.5) -> float:
    """Reference-faithful AP including the mrec/mpre name swap
    (`utils/mAP.py:88-89`): the "recall axis" is actually precision.

    Tie order cannot change this value: the quirk AP reduces to
    ``final_recall × final_precision`` (see module docstring), so our
    stable tie sort and the reference's tie-reversing
    ``argsort(scores)[::-1]`` give the same number — oracle parity holds
    even on fully tied scores (`tests/test_map_eval.py::TestTieOrdering`).
    """
    tp, gt_num = _tp_and_count(data, class_id, thresh)
    precision_list, recall_list = _precision_recall(tp, gt_num)
    mrec = np.concatenate(([0.0], precision_list, [1.0]))
    mpre = np.concatenate(([0.0], recall_list, [0.0]))
    return _envelope_area(mrec, mpre)


def _greedy_rows(data: Sequence[Dict], class_id: int, thresh: float):
    """Score-greedy TP/FP rows (tp_flag, score) + GT count for one class."""
    rows = []
    gt_num = 0
    for d in data:
        gt = np.asarray(d["groud_truth"], dtype=np.float64).reshape(-1, 5)
        gt = gt[gt[:, 4] == class_id][:, :4]
        gt_num += gt.shape[0]
        pred = np.asarray(d["prediction"], dtype=np.float64).reshape(-1, 6)
        pred = pred[pred[:, 4] == class_id]
        order = np.argsort(-pred[:, 5], kind="stable")
        claimed = np.zeros(gt.shape[0], dtype=bool)
        for pi in order:
            p = pred[pi]
            if gt.shape[0] == 0:
                rows.append((0.0, p[5]))
                continue
            inter_wh = np.maximum(
                np.minimum(gt[:, 2:4], p[2:4]) - np.maximum(gt[:, 0:2], p[0:2]), 0.0
            )
            inter = inter_wh[:, 0] * inter_wh[:, 1]
            union = (
                np.prod(gt[:, 2:4] - gt[:, 0:2], axis=1)
                + np.prod(p[2:4] - p[0:2])
                - inter
            )
            iou = inter / union
            best = int(np.argmax(iou))
            if iou[best] >= thresh and not claimed[best]:
                claimed[best] = True
                rows.append((1.0, p[5]))
            else:
                rows.append((0.0, p[5]))
    return rows, gt_num


def get_ap_voc(data: Sequence[Dict], class_id: int, thresh: float = 0.5) -> float:
    """Corrected VOC AP: proper axes and score-greedy TP matching."""
    rows, gt_num = _greedy_rows(data, class_id, thresh)
    tp = np.asarray(rows).reshape(-1, 2)
    tp = tp[np.argsort(-tp[:, 1], kind="stable"), :]
    precision_list, recall_list = _precision_recall(tp, gt_num)
    mrec = np.concatenate(([0.0], recall_list, [1.0]))
    mpre = np.concatenate(([0.0], precision_list, [0.0]))
    return _envelope_area(mrec, mpre)


def get_ap_coco(data: Sequence[Dict], class_id: int, thresh: float = 0.5):
    """COCO-official AP at one IoU threshold: 101-point interpolated PR.

    Returns None when the class has no ground truth (COCO excludes such
    classes from the mean instead of scoring them 0).
    """
    rows, gt_num = _greedy_rows(data, class_id, thresh)
    if gt_num == 0:
        return None
    if not rows:
        return 0.0
    tp = np.asarray(rows).reshape(-1, 2)
    tp = tp[np.argsort(-tp[:, 1], kind="stable"), :]
    precision, recall = _precision_recall(tp, gt_num)
    # precision envelope (monotone non-increasing from the right)
    pre = np.concatenate((precision, [0.0]))
    for i in range(len(pre) - 2, -1, -1):
        pre[i] = max(pre[i], pre[i + 1])
    levels = np.linspace(0.0, 1.0, 101)
    idx = np.searchsorted(recall, levels, side="left")
    interp = np.where(idx < len(precision), pre[idx], 0.0)
    return float(interp.mean())


def get_map_coco(data: Sequence[Dict], class_num: int,
                 threshs: Sequence[float] = None) -> float:
    """COCO mAP@[.5:.95] (10 IoU thresholds, 101-pt interpolation), mean
    over classes that have ground truth."""
    if threshs is None:
        threshs = np.arange(0.5, 0.955, 0.05)
    aps = []
    for t in threshs:
        for c in range(class_num):
            ap = get_ap_coco(data, c, float(t))
            if ap is not None:
                aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


def get_map(data: Sequence[Dict], class_num: int, thresh: float = 0.5,
            variant: str = "reference") -> float:
    """Mean AP over all class ids in ``[0, class_num)`` (`utils/mAP.py:103-110`)."""
    ap_fn = get_ap if variant == "reference" else get_ap_voc
    return sum(ap_fn(data, c, thresh) for c in range(class_num)) / class_num


def get_map_one(groud_truth: List, prediction: List, class_num: int,
                thresh: float = 0.5, variant: str = "reference") -> float:
    """Single-image mAP, the per-batch eval hook (`utils/mAP.py:114-125`)."""
    data = [{"image_path": "*.jpg", "groud_truth": groud_truth,
             "prediction": prediction}]
    return get_map(data, class_num=class_num, thresh=thresh, variant=variant)

"""LFW verification evaluation (10-fold ROC, accuracy, VAL@FAR).

Copy of ``tmv_tpu/models/facenet/lfw.py`` (the reference's
`facenet/lfw.py:37-202`, itself from davidsandberg/facenet, MIT): pairs.txt
parsing, squared-euclidean / cosine distances, per-fold best-threshold accuracy
over a 0-4 sweep, and VAL at FAR=1e-3 with linear threshold interpolation, in
numpy. The JAX package splits the folds with ``sklearn.model_selection.KFold``;
this copy keeps its own ``KFold`` (sklearn's unshuffled splits), so the port
needs no sklearn.
"""

import math
import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np


class KFold:
    """``sklearn.model_selection.KFold(n_splits, shuffle=False)``: consecutive
    test folds, the first ``n % n_splits`` of them one index longer, each with
    the remaining indices in order as its training set."""

    def __init__(self, n_splits: int = 5, shuffle: bool = False):
        if shuffle:
            raise ValueError("this KFold splits in order only (shuffle=False)")
        if n_splits < 2:
            raise ValueError(f"k-fold cross-validation needs n_splits >= 2, got {n_splits}")
        self.n_splits = n_splits

    def split(self, x) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(x)
        if self.n_splits > n:
            raise ValueError(f"cannot have n_splits={self.n_splits} greater than the "
                             f"number of samples n_samples={n}")
        indices = np.arange(n)
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[: n % self.n_splits] += 1
        start = 0
        for size in sizes:
            test = indices[start:start + size]
            yield np.concatenate([indices[:start], indices[start + size:]]), test
            start += size


def distance(e1: np.ndarray, e2: np.ndarray, distance_metric: int = 0):
    if distance_metric == 0:
        return np.sum(np.square(e1 - e2), axis=1)
    if distance_metric == 1:
        dot = np.sum(e1 * e2, axis=1)
        norm = np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1)
        # clip: float error can push |cos| past 1 (reference would NaN)
        return np.arccos(np.clip(dot / norm, -1.0, 1.0)) / math.pi
    raise ValueError(f"Undefined distance metric {distance_metric}")


def _accuracy(threshold, dist, issame):
    pred = dist < threshold
    tp = np.sum(pred & issame)
    fp = np.sum(pred & ~issame)
    tn = np.sum(~pred & ~issame)
    fn = np.sum(~pred & issame)
    tpr = 0.0 if tp + fn == 0 else tp / (tp + fn)
    fpr = 0.0 if fp + tn == 0 else fp / (fp + tn)
    return tpr, fpr, (tp + tn) / dist.size


def _val_far(threshold, dist, issame):
    pred = dist < threshold
    ta = np.sum(pred & issame)
    fa = np.sum(pred & ~issame)
    n_same = np.sum(issame)
    n_diff = np.sum(~issame)
    val = ta / n_same if n_same > 0 else 0.0
    far = fa / n_diff if n_diff > 0 else 0.0
    return val, far


def calculate_roc(thresholds, e1, e2, issame, nrof_folds=10,
                  distance_metric=0, subtract_mean=False):
    n = min(len(issame), e1.shape[0])
    folds = KFold(n_splits=nrof_folds, shuffle=False)
    tprs = np.zeros((nrof_folds, len(thresholds)))
    fprs = np.zeros((nrof_folds, len(thresholds)))
    accuracy = np.zeros(nrof_folds)
    issame = np.asarray(issame)
    for fold_idx, (train_set, test_set) in enumerate(folds.split(np.arange(n))):
        mean = (
            np.mean(np.concatenate([e1[train_set], e2[train_set]]), axis=0)
            if subtract_mean else 0.0
        )
        dist = distance(e1 - mean, e2 - mean, distance_metric)
        acc_train = np.array([
            _accuracy(t, dist[train_set], issame[train_set])[2]
            for t in thresholds
        ])
        best = int(np.argmax(acc_train))
        for ti, t in enumerate(thresholds):
            tprs[fold_idx, ti], fprs[fold_idx, ti], _ = _accuracy(
                t, dist[test_set], issame[test_set])
        _, _, accuracy[fold_idx] = _accuracy(
            thresholds[best], dist[test_set], issame[test_set])
    return np.mean(tprs, 0), np.mean(fprs, 0), accuracy


def calculate_val(thresholds, e1, e2, issame, far_target, nrof_folds=10,
                  distance_metric=0, subtract_mean=False):
    n = min(len(issame), e1.shape[0])
    folds = KFold(n_splits=nrof_folds, shuffle=False)
    val = np.zeros(nrof_folds)
    far = np.zeros(nrof_folds)
    issame = np.asarray(issame)
    for fold_idx, (train_set, test_set) in enumerate(folds.split(np.arange(n))):
        mean = (
            np.mean(np.concatenate([e1[train_set], e2[train_set]]), axis=0)
            if subtract_mean else 0.0
        )
        dist = distance(e1 - mean, e2 - mean, distance_metric)
        far_train = np.array([
            _val_far(t, dist[train_set], issame[train_set])[1]
            for t in thresholds
        ])
        if np.max(far_train) >= far_target:
            threshold = float(np.interp(far_target, far_train, thresholds))
        else:
            threshold = 0.0
        val[fold_idx], far[fold_idx] = _val_far(
            threshold, dist[test_set], issame[test_set])
    return float(np.mean(val)), float(np.std(val)), float(np.mean(far))


def evaluate(embeddings: np.ndarray, actual_issame: Sequence[bool],
             nrof_folds=10, distance_metric=0, subtract_mean=False):
    """(tpr, fpr, accuracy, val, val_std, far) — `lfw.py:149-160`."""
    thresholds = np.arange(0, 4, 0.01)
    e1 = embeddings[0::2]
    e2 = embeddings[1::2]
    tpr, fpr, accuracy = calculate_roc(
        thresholds, e1, e2, actual_issame, nrof_folds, distance_metric,
        subtract_mean)
    thresholds = np.arange(0, 4, 0.001)
    val, val_std, far = calculate_val(
        thresholds, e1, e2, actual_issame, 1e-3, nrof_folds,
        distance_metric, subtract_mean)
    return tpr, fpr, accuracy, val, val_std, far


def read_pairs(pairs_filename: str) -> np.ndarray:
    pairs = []
    with open(pairs_filename, "r") as f:
        for line in f.readlines()[1:]:
            pairs.append(line.strip().split())
    return np.array(pairs, dtype=object)


def _add_extension(path: str) -> str:
    for ext in (".jpg", ".png"):
        if os.path.exists(path + ext):
            return path + ext
    raise RuntimeError(f'No file "{path}" with extension png or jpg.')


def get_paths(lfw_dir: str, pairs) -> Tuple[List[str], List[bool]]:
    """pairs.txt rows → interleaved path list + issame flags."""
    skipped = 0
    path_list: List[str] = []
    issame_list: List[bool] = []
    for pair in pairs:
        if len(pair) == 3:
            p0 = os.path.join(lfw_dir, pair[0], f"{pair[0]}_{int(pair[1]):04d}")
            p1 = os.path.join(lfw_dir, pair[0], f"{pair[0]}_{int(pair[2]):04d}")
            issame = True
        else:
            p0 = os.path.join(lfw_dir, pair[0], f"{pair[0]}_{int(pair[1]):04d}")
            p1 = os.path.join(lfw_dir, pair[2], f"{pair[2]}_{int(pair[3]):04d}")
            issame = False
        try:
            p0, p1 = _add_extension(p0), _add_extension(p1)
        except RuntimeError:
            skipped += 1
            continue
        path_list += [p0, p1]
        issame_list.append(issame)
    if skipped:
        print(f"Skipped {skipped} image pairs")
    return path_list, issame_list

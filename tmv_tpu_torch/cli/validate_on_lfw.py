"""LFW validation CLI: accuracy, VAL@FAR, AUC and EER.

Port of ``tmv_tpu/cli/validate_on_lfw.py`` (the reference's
`facenet/validate_on_lfw.py`): embed an LFW pair list with a FaceNet checkpoint
(``core/checkpoint.py::load_weights``: a checkpoint directory of
``cli/train_facenet.py`` or a bare ``state_dict`` ``.pt``) and print the 10-fold
verification metrics of ``models/facenet/lfw.py`` in the JAX CLI's four lines.
``--device cuda`` (the default) raises where there is no GPU.

Usage:
    python -m tmv_tpu_torch.cli.validate_on_lfw --lfwDir ./lfw \\
        --lfwPairs ./pairs.txt --modelPath ./data/facenet_weights
"""

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--lfwDir", required=True)
    p.add_argument("--lfwPairs", required=True)
    p.add_argument("--modelPath", required=True)
    p.add_argument("--backbone", default="InceptionResNetV1")
    p.add_argument("--embeddingSize", type=int, default=512)
    p.add_argument("--imageSize", type=int, default=160)
    p.add_argument("--batchSize", type=int, default=32)
    p.add_argument("--distanceMetric", type=int, default=0)
    p.add_argument("--subtractMean", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    """Print the four lines; returns ``{"accuracy", "val", "val_std", "far",
    "auc", "eer"}`` (``accuracy`` per fold)."""
    from tmv_tpu_torch.cli.train_facenet import evaluate_lfw
    from tmv_tpu_torch.core.checkpoint import load_weights
    from tmv_tpu_torch.models.detector_harness import check_device
    from tmv_tpu_torch.models.facenet import FaceNetModel

    args = parse_args(argv)
    model = FaceNetModel(args.embeddingSize, args.backbone, device=check_device(args.device))
    load_weights(model, args.modelPath)
    tpr, fpr, accuracy, val, val_std, far = evaluate_lfw(
        model, args.lfwDir, args.lfwPairs, args.imageSize, args.batchSize,
        distance_metric=args.distanceMetric, subtract_mean=args.subtractMean)
    auc = float(np.trapezoid(tpr, fpr))
    # EER: where FNR crosses FPR
    fnr = 1 - tpr
    eer_idx = int(np.argmin(np.abs(fnr - fpr)))
    eer = float((fnr[eer_idx] + fpr[eer_idx]) / 2)
    print(f"Accuracy: {accuracy.mean():.5f}+-{accuracy.std():.5f}")
    print(f"Validation rate: {val:.5f}+-{val_std:.5f} @ FAR={far:.5f}")
    print(f"Area Under Curve (AUC): {auc:.5f}")
    print(f"Equal Error Rate (EER): {eer:.5f}")
    return {"accuracy": accuracy, "val": val, "val_std": val_std, "far": far, "auc": auc,
            "eer": eer}


if __name__ == "__main__":
    main()

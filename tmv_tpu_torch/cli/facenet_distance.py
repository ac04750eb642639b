"""Embed a list of face images and print their squared-distance matrix.

Port of ``tmv_tpu/cli/facenet_distance.py`` (the reference's
`facenet/test.py:24-56`): load the images, embed them with a FaceNet checkpoint
(``core/checkpoint.py::load_weights``) in one batch of ``max(4, N)``, and print
the squared euclidean distance of every pair in the JAX CLI's format.
``--device cuda`` (the default) raises where there is no GPU.

Usage:
    python -m tmv_tpu_torch.cli.facenet_distance a.jpg b.jpg c.jpg \\
        --modelPath ./data/facenet_weights
"""

import argparse

import numpy as np


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("images", nargs="+")
    p.add_argument("--modelPath", required=True)
    p.add_argument("--backbone", default="InceptionResNetV1")
    p.add_argument("--embeddingSize", type=int, default=512)
    p.add_argument("--imageSize", type=int, default=160)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> np.ndarray:
    """Print the matrix; returns it, ``(N, N)`` float."""
    from tmv_tpu_torch.cli.train_facenet import load_images
    from tmv_tpu_torch.core.checkpoint import load_weights
    from tmv_tpu_torch.models.detector_harness import check_device
    from tmv_tpu_torch.models.facenet import FaceNetModel, get_embeddings

    args = parse_args(argv)
    model = FaceNetModel(args.embeddingSize, args.backbone, device=check_device(args.device))
    load_weights(model, args.modelPath)
    emb = get_embeddings(model, load_images(args.images, args.imageSize),
                         batch_size=max(4, len(args.images)))
    n = len(args.images)
    matrix = np.array([[float(np.sum((emb[i] - emb[j]) ** 2)) for j in range(n)]
                       for i in range(n)])
    print("Distance matrix (squared euclidean):")
    print("      " + "  ".join(f"{i:8d}" for i in range(n)))
    for i in range(n):
        print(f"{i:4d}  " + "  ".join(f"{d:8.4f}" for d in matrix[i]))
    return matrix


if __name__ == "__main__":
    main()

"""How much NMS work the seeded EfficientDet-D0 load of ``chip_smoke.py`` gives.

Builds the port's D0 (81 classes) with ``--randomInit --seed 0`` weights, once
with the focal class prior alone and once with ``chip_smoke.py``'s adjustment
(the 80 foreground classes' predict bias at +1.0), predicts seeded images and
prints, per image, the anchors whose argmax class is foreground with a raw logit
at or above the 1e-4 threshold, the boxes kept after NMS, and the largest box
regression. Runs on the CPU at a reduced size or on the card at 512:

    python tools/torch_d0_seeded_load.py --imageSize 256 --device cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--imageSize", type=int, default=512)
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=2)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    import chip_smoke
    from tmv_tpu_torch.models.efficientdet.harness import make_efficientdet_predict_batched

    size = args.imageSize
    images = np.random.default_rng(11).uniform(0, 1, (args.batch, size, size, 3))
    images = images.astype(np.float32)
    model, anchors = chip_smoke.seeded_d0(torch.float32, args.device, size)
    prior = model.class_net.net.predict.pointwise.bias.view(9, 81)[0, 0].item()
    for label, bias in (("class prior alone", prior), ("foreground bias +1.0", 1.0)):
        with torch.no_grad():
            model.class_net.net.predict.pointwise.bias.view(9, 81)[:, 1:] = bias
        with torch.inference_mode():
            boxes_out, classes_out = model(torch.from_numpy(images).to(args.device))
            logits = torch.cat([c.float().reshape(args.batch, -1, 81) for c in classes_out], 1)
            above = ((logits.argmax(-1) != 0) & (logits.amax(-1) >= 1e-4)).sum(1).tolist()
            box_max = max(float(b.abs().max()) for b in boxes_out)
        kept = make_efficientdet_predict_batched(model, anchors, size)(None, images)[3].sum(1)
        print(f"D0 @{size} on {args.device}, {label} ({bias:+.3f}): foreground anchors with a "
              f"raw logit >= 1e-4 per image {above} of {logits.shape[1]}; kept per image "
              f"{kept.tolist()} (cap 200); max |box regression| {box_max:.3g}")


if __name__ == "__main__":
    main()

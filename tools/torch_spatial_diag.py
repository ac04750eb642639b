"""Hold the port's height-sharded predictor against the unsharded one on the card, in
bf16 and f32, for YOLOv4 @640 and EfficientDet-D0 @512.

    python tools/torch_spatial_diag.py

It builds the kernels and the seeded serving weights as ``chip_smoke.py``'s phases 1, 2,
4 and 8 do, then, for each model, dtype (bf16, and f32 with TF32 off) and cuDNN
determinism setting, runs four letterboxed scenes through the unsharded batched
predictor and through ``make_spatial_predictor`` over ``[cuda:0, cuda:0]``, and prints
per frame the heads' largest difference over the largest head value, the sweep masks'
differing bits against their kept bits, and the share of each side's kept boxes the
other keeps (same class, IoU >= 0.5).
"""

import copy
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402


def flat(outputs):
    if isinstance(outputs, (tuple, list)):
        return [t for o in outputs for t in flat(o)]
    return [outputs]


def main():
    import torch

    from tmv_tpu_torch.cli import serve
    from tmv_tpu_torch.core.checkpoint import load_weights
    from tmv_tpu_torch.kernels.nms_sweep import greedy_sweep
    from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS
    from tmv_tpu_torch.parallel.inference import make_spatial_predictor, shard_predict_spatial

    card = cs.phase_environment()
    os.makedirs(cs.WORK, exist_ok=True)
    cs.phase_build(card)
    _, weights = cs.phase_slice(card)
    d0_weights = cs.phase_d0_slice(card)
    classes_file, anchors_file = cs.write_inputs(cs.COCO_CLASSES, COCO_ANCHORS)
    for family, flags, size in (
            ("yolo", ["--modelPath", weights, "--anchorsFile", anchors_file], cs.IMAGE),
            ("d0", ["--family", "efficientdet", "--modelName", "efficientdet-d0", "--modelPath",
                    d0_weights], cs.D0_IMAGE)):
        frames = [cs.prepared_scene(90 + i, size) for i in range(4)]
        for dtype, name in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            for deterministic in (False, True):
                torch.backends.cudnn.deterministic = deterministic
                args = serve.parse_args(flags + ["--classesFile", classes_file, "--imageSize",
                                                 str(size), "--device", "cuda"]
                                        + (["--bf16"] if name == "bf16" else []))
                model, make_batched, _ = serve._build_model(args, 80, dtype)
                load_weights(model, args.modelPath)
                model = model.to(device="cuda", memory_format=torch.channels_last).eval()
                one = make_batched("off", model)
                sharded, _, _ = make_spatial_predictor(model, lambda f: make_batched("off", f),
                                                       devices=["cuda:0", "cuda:0"])
                forward = shard_predict_spatial([model, copy.deepcopy(model)],
                                                ["cuda:0", "cuda:0"])
                plain, split = cs.SweepLog(greedy_sweep), cs.SweepLog(greedy_sweep)
                heads_err, wants, gots = [], [], []
                for frame in frames:
                    x = torch.as_tensor(frame).cuda()
                    with torch.inference_mode():
                        want, got = model(x), forward(x)
                    heads_err.append(max(
                        float((g.float() - w.float()).abs().max() / w.float().abs().max())
                        for g, w in zip(flat(got), flat(want))))
                    with plain.patch():
                        wants.append(one(None, frame))
                    with split.patch():
                        gots.append(sharded(None, frame))
                bits = [int((a != b).sum()) for a, b in zip(plain.masks, split.masks)]
                want = tuple(np.concatenate([w[k] for w in wants]) for k in range(4))
                got = tuple(np.concatenate([g[k] for g in gots]) for k in range(4))
                agree = (cs.box_agreement(want, got)[0], cs.box_agreement(got, want)[0])
                print(f"{family} {name} cudnn.deterministic={deterministic}: heads max|diff|/"
                      f"max|ref| {['%.3g' % e for e in heads_err]}; differing mask bits per "
                      f"frame {bits} of {[int(m.sum()) for m in plain.masks]} kept; box "
                      f"agreement {agree[0]:.4f} / {agree[1]:.4f} on [{card}]", flush=True)
                forward.close()
                sharded.close()
                del model, one, sharded, forward
                torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

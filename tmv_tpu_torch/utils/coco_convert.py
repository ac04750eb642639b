"""COCO annotation JSON → the repo's pipe-delimited label format.

The port's own copy of ``tmv_tpu/utils/coco_convert.py`` (json only).

Capability parity with `AIServer/ai_api/ai_models/utils/coco.py:25-105`
(which shells through pycocotools): emits
``coco_<split>_labels.txt`` lines ``file.jpg|name,x1,y1,x2,y2|…`` and
``coco_classes.txt``.  Plain-json implementation — no pycocotools needed.
"""

import json
import os
from collections import defaultdict


def coco_to_labels(ann_file: str, out_dir: str, data_type: str = "train2017"):
    with open(ann_file, "r", encoding="utf-8") as f:
        coco = json.load(f)

    cats = sorted(coco["categories"], key=lambda c: c["id"])
    classes_name = {c["id"]: c["name"] for c in cats}
    names = [c["name"] for c in cats]

    anns_by_img = defaultdict(list)
    for ann in coco.get("annotations", []):
        if ann.get("iscrowd"):
            continue
        anns_by_img[ann["image_id"]].append(ann)

    os.makedirs(out_dir, exist_ok=True)
    labels_path = os.path.join(out_dir, f"coco_{data_type}_labels.txt")
    with open(labels_path, "w", encoding="utf-8") as f:
        for img in coco["images"]:
            parts = [img["file_name"]]
            for ann in anns_by_img.get(img["id"], []):
                x, y, w, h = ann["bbox"]
                parts.append(
                    f"{classes_name[ann['category_id']]},{x},{y},{x + w},{y + h}"
                )
            f.write("|".join(parts) + "|\n")

    classes_path = os.path.join(out_dir, "coco_classes.txt")
    with open(classes_path, "w", encoding="utf-8") as f:
        for n in names:
            f.write(n + "\n")
    return labels_path, classes_path

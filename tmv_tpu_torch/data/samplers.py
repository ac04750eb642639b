"""Class-balanced infinite label sampler.

The port's own copy of ``tmv_tpu/data/samplers.py`` (``DataGenerator.Generate``,
`datasets/coco_dataset.py:287-313`): shuffle the label list each epoch with
``random.Random(seed)``, then round-robin over the observed class set, skipping
images that lack the next wanted class. Pure Python, so a seed yields the same
label sequence as the JAX package's sampler.
"""

import random
from typing import Dict, Iterator, List, Sequence


class ClassBalancedSampler:
    def __init__(self, labels: Sequence[Dict], label_mean: bool = True,
                 seed: int | None = None):
        self.labels = list(labels)
        self.label_mean = label_mean
        self._rng = random.Random(seed)
        self.class_list: List[int] = []
        self.image_class_list: Dict[str, List[int]] = {}
        if label_mean:
            class_set = set()
            for label in self.labels:
                img_classes = set(label["classes"])
                class_set.update(img_classes)
                self.image_class_list[label["image_path"]] = list(img_classes)
            self.class_list = list(class_set)

    def __iter__(self) -> Iterator[Dict]:
        n = len(self.labels)
        i = 0
        class_index = 0
        clone = self.labels.copy()
        while True:
            if i == 0:
                self._rng.shuffle(clone)
            label = clone[i]
            if self.class_list and self.label_mean:
                wanted = self.class_list[class_index]
                if wanted not in self.image_class_list[label["image_path"]]:
                    i = (i + 1) % n
                    continue
                class_index = (class_index + 1) % len(self.class_list)
            i = (i + 1) % n
            yield label

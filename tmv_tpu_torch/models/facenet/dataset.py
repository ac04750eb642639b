"""FaceNet directory dataset: person-per-folder scan + batch sampling.

Copy of ``tmv_tpu/models/facenet/dataset.py`` (the reference's
`facenet/dataset.py:5-95`): scan ``files_path/<person>/*.jpg`` (people with at
least two images), then per outer step sample up to ``people_per_batch``
people × ``images_per_person`` images and return (paths, num_per_class) for the
mining pass. The draws come from the standard library's ``random.Random(seed)``,
so a seed gives the JAX package's ``sample_people()``.
"""

import os
import random
from typing import Iterator, List, Tuple


class FaceDataset:
    def __init__(self, files_path: str, people_per_batch: int,
                 images_per_person: int, seed: int | None = None):
        self.people_per_batch = people_per_batch
        self.images_per_person = images_per_person
        self._rng = random.Random(seed)
        self.people: List[List[str]] = []
        for name in sorted(os.listdir(files_path)):
            d = os.path.join(files_path, name)
            if not os.path.isdir(d):
                continue
            imgs = [
                os.path.join(d, f) for f in sorted(os.listdir(d))
                if f.lower().endswith((".jpg", ".jpeg", ".png"))
            ]
            if len(imgs) >= 2:  # need at least one (anchor, positive) pair
                self.people.append(imgs)

    def sample_people(self) -> Tuple[List[str], List[int]]:
        """One mining batch: shuffled people, ≤images_per_person each."""
        order = list(range(len(self.people)))
        self._rng.shuffle(order)
        paths: List[str] = []
        num_per_class: List[int] = []
        for pi in order[: self.people_per_batch]:
            imgs = self.people[pi].copy()
            self._rng.shuffle(imgs)
            chosen = imgs[: self.images_per_person]
            paths.extend(chosen)
            num_per_class.append(len(chosen))
        return paths, num_per_class

    def __iter__(self) -> Iterator[Tuple[List[str], List[int]]]:
        while True:
            yield self.sample_people()

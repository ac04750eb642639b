"""Weight grafting: copy the matching entries between two ``state_dict``\\ s.

Port of ``tmv_tpu/convert/graft.py::graft_params`` on torch ``state_dict``\\ s
(flat names in place of flax's nested paths). The MoCo → detection fine-tune
(`momentum_contrast/train_object_detection.py`) loads a pretrained tower into a
detector whose output convs differ; every entry whose name and shape match is
copied, every other keeps the destination's value.
"""

from typing import Dict, List, Tuple

import torch


def graft_params(dst: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor]
                 ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Return ``(grafted, copied, skipped)``: a copy of ``dst`` whose entries
    are ``src``'s where the name exists in ``src`` with the same shape, the
    names copied, and the names present in both with another shape (e.g. the
    output convs after a change of class count), each in ``dst``'s order."""
    grafted, copied, skipped = {}, [], []
    for name, value in dst.items():
        other = src.get(name)
        if other is not None and tuple(other.shape) == tuple(value.shape):
            grafted[name] = other.detach().to(device=value.device, dtype=value.dtype).clone()
            copied.append(name)
        else:
            grafted[name] = value
            if other is not None:
                skipped.append(name)
    return grafted, copied, skipped

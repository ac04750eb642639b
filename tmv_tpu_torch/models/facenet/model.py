"""FaceNet: the embedding model, batched embedding and semi-hard triplet mining.

Port of ``tmv_tpu/models/facenet/model.py`` (the reference's
`facenet_model.py`):

- ``FaceNetModel``: a backbone (InceptionResNetV1/V2, InceptionV4 or
  RepVGG-B2g4) with ``embedding_size`` outputs, then ``x / sqrt(max(Σx², 1e-10))``.
  It takes NHWC images in [0, 1] and runs NCHW in ``channels_last`` memory. The
  backbone is the submodule ``{class}_0``, as in the flax tree, so
  ``convert.flax_bridge`` maps a JAX FaceNet onto it.
- ``get_embeddings``: batched eval-mode inference with the last batch padded to
  the batch size, as the JAX function pads it for its jit.
- ``select_triplets``: for each (anchor, later positive) pair of one person, one
  random negative among those with ``(neg − pos < α ∧ pos < neg) ∨ neg < pos``,
  chosen by masked Gumbel-max, with the JAX function's output layout: ``(n², 3)``
  flat indices and an ``(n²,)`` valid mask, ``n = P·I``. The JAX function builds
  its condition, noise and scores over ``(n, n, n)`` (23 GB per float32 tensor at
  the CLI's n = 1800); anchor-positive pairs exist only within a person, so here
  they are mined per person block over ``(P, I, I, n)`` and scattered into the
  n²-row layout; every row outside a block keeps JAX's ``(a, p, 0)``, invalid.
- ``make_triplet_train_step``: the triplet loss of one train-mode forward over
  the concatenated anchors, positives and negatives, for
  ``core.train_state.make_train_step``.
"""

import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from tmv_tpu_torch.models.backbones.inception_resnet_v1 import InceptionResNetV1
from tmv_tpu_torch.models.backbones.inception_resnet_v2 import InceptionResNetV2
from tmv_tpu_torch.models.backbones.inception_v4 import InceptionV4
from tmv_tpu_torch.models.backbones.repvgg import RepVGG, get_repvgg_by_name
from tmv_tpu_torch.ops.losses import triplet_loss

BACKBONES = ("InceptionResNetV1", "InceptionResNetV2", "InceptionV4", "RepVGG")
# stddev of a unit-variance normal truncated to ±2 (flax's variance_scaling)
_TRUNCATED_STD = 0.87962566103423978


class FaceNetModel(nn.Module):
    """NHWC images → L2-normalized ``(B, embedding_size)`` embeddings;
    ``generator`` feeds the Inception heads' train-mode dropout (RepVGG has
    none)."""

    def __init__(self, embedding_size: int, backbone: str = "InceptionResNetV1",
                 dropout_rate: float = 0.2, device=None, remat: bool = False):
        super().__init__()
        inception = {"InceptionResNetV1": InceptionResNetV1,
                     "InceptionResNetV2": InceptionResNetV2, "InceptionV4": InceptionV4}
        if backbone in inception:
            net = inception[backbone](embedding_size, dropout_rate, device, remat)
        elif backbone == "RepVGG":
            net = get_repvgg_by_name("RepVGG-B2g4", embedding_size, device=device, remat=remat)
        else:
            raise ValueError(f"unknown backbone {backbone!r}")
        self.backbone_name = f"{type(net).__name__}_0"
        self.add_module(self.backbone_name, net)

    @property
    def backbone(self) -> nn.Module:
        return self._modules[self.backbone_name]

    def forward(self, images: torch.Tensor, generator: Optional[torch.Generator] = None):
        net = self.backbone
        x = images.permute(0, 3, 1, 2).to(next(net.parameters()).dtype,
                                          memory_format=torch.channels_last)
        x = net(x) if isinstance(net, RepVGG) else net(x, generator)
        norm = torch.sqrt(torch.clamp(torch.sum(torch.square(x), dim=1, keepdim=True),
                                      min=1e-10))
        return x / norm


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded init with flax's defaults: conv and dense kernels ``lecun_normal``
    (variance 1/fan_in, a normal truncated at ±2 std), zero biases, identity
    BatchNorm. Drawn on the CPU from one ``torch.Generator`` in module order, so
    a seed gives the same weights on every device (not the JAX package's values:
    its draws are threefry's)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / _TRUNCATED_STD
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


def get_embeddings(model: FaceNetModel, images: np.ndarray, batch_size: int) -> np.ndarray:
    """Embed ``images`` (NHWC numpy) in batches of ``batch_size`` in eval mode on
    the model's device, the last batch padded with zeros (`facenet_model.py:153-175`);
    the model's train/eval mode is put back afterwards."""
    device = next(model.parameters()).device
    was_training = model.training
    model.eval()
    out = []
    try:
        with torch.inference_mode():
            for start in range(0, images.shape[0], batch_size):
                chunk = images[start:start + batch_size]
                pad = batch_size - chunk.shape[0]
                if pad:
                    chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:],
                                                            chunk.dtype)])
                emb = model(torch.from_numpy(np.ascontiguousarray(chunk)).to(device))
                out.append(emb[:batch_size - pad].cpu().numpy())
    finally:
        model.train(was_training)
    return np.concatenate(out, axis=0)


def draw_gumbel(shape, generator: torch.Generator, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """Standard Gumbel noise ``−log(−log(u))``, ``u`` uniform on [tiny, 1), as
    ``jax.random.gumbel`` draws it, from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(dtype).tiny)))


def select_triplets(embeddings_grid: torch.Tensor, valid_grid: torch.Tensor, alpha: float,
                    generator: Optional[torch.Generator] = None,
                    gumbel: Optional[torch.Tensor] = None):
    """Semi-hard triplet mining over a padded ``(P, I, D)`` embedding grid.

    Args:
        embeddings_grid: ``(people, images, D)``; padded rows arbitrary.
        valid_grid: ``(people, images)`` bool.
        generator: draws the Gumbel noise (on the grid's device) unless
            ``gumbel`` is given.
        gumbel: the noise itself, either JAX's ``(n, n, n)`` draws (each block
            reads its anchors' rows and positives' columns) or the blocks'
            ``(P, I, I, n)``.

    Returns:
        (triplets, valid): ``(n², 3)`` int64 flat indices ``(a, p, neg)`` into the
        flattened ``(P·I, D)`` embeddings, row ``a·n + p``, and an ``(n²,)`` bool
        mask, on the grid's device: the JAX function's output, row for row, for
        the same noise.
    """
    p_num, i_num, d = embeddings_grid.shape
    n, device = p_num * i_num, embeddings_grid.device
    flat = embeddings_grid.reshape(n, d)
    valid_flat = valid_grid.reshape(n)
    # pairwise squared distances, JAX's formula (not cdist: no square roots, one algorithm)
    sq = torch.sum(torch.square(flat), dim=1)
    dists = sq[:, None] + sq[None, :] - 2.0 * flat @ flat.T
    people = torch.arange(p_num, device=device)
    person_of = people.repeat_interleave(i_num)

    # per block b: anchors and positives are b's images, negatives all n
    neg = dists.reshape(p_num, i_num, 1, n)                          # (P, a, 1, m)
    pos = dists.reshape(p_num, i_num, p_num, i_num)[people, :, people]    # (P, a, p)
    later = torch.ones(i_num, i_num, dtype=torch.bool, device=device).triu(1)
    ap_valid = later & valid_grid[:, :, None] & valid_grid[:, None, :]    # (P, a, p)
    neg_ok = (person_of[None, :] != people[:, None]) & valid_flat[None, :]   # (P, m)
    pos = pos[..., None]
    cond = ((neg - pos < alpha) & (pos < neg)) | (neg < pos)             # (P, a, p, m)
    cond &= neg_ok[:, None, None, :] & ap_valid[..., None]

    if gumbel is None:
        score = draw_gumbel(cond.shape, generator, device, dists.dtype)
        score.masked_fill_(~cond, -math.inf)
    else:
        if tuple(gumbel.shape) == (n, n, n):
            gumbel = gumbel.reshape(p_num, i_num, p_num, i_num, n)[people, :, people]
        score = torch.where(cond, gumbel.to(device, dists.dtype),
                            torch.tensor(-math.inf, dtype=dists.dtype, device=device))
    n_block = torch.argmax(score, dim=-1)             # the first index where all are -inf
    valid_block = ap_valid & torch.any(cond, dim=-1)
    del cond, score

    n_idx = torch.zeros((n, n), dtype=torch.long, device=device)
    n_idx.view(p_num, i_num, p_num, i_num)[people, :, people] = n_block
    valid = torch.zeros((n, n), dtype=torch.bool, device=device)
    valid.view(p_num, i_num, p_num, i_num)[people, :, people] = valid_block
    rows = torch.arange(n, device=device)
    triplets = torch.stack([rows.repeat_interleave(n), rows.repeat(n), n_idx.reshape(-1)], -1)
    return triplets, valid.reshape(-1)


def make_triplet_train_step(alpha: float, generator: Optional[torch.Generator] = None):
    """Loss for ``core.train_state.make_train_step``: ``(model, batch) -> (loss,
    {})``, the triplet loss of one train-mode forward over ``batch["anchor"]``,
    ``["positive"]`` and ``["negative"]`` concatenated (so the BatchNorm
    statistics see all three), with ``batch["valid"]`` where given; ``generator``
    feeds the head's dropout."""

    def loss_fn(model, batch):
        images = torch.cat([batch["anchor"], batch["positive"], batch["negative"]], dim=0)
        emb = model(images, generator=generator)
        b = batch["anchor"].shape[0]
        loss = triplet_loss(emb[:b], emb[b:2 * b], emb[2 * b:], alpha, valid=batch.get("valid"))
        return loss, {}

    return loss_fn

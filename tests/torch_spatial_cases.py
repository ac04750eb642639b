"""Height-sharded cases of the port: narrow YOLOv4/YOLOv3 twins and the rank workers.

- ``NarrowYoloV4``/``NarrowYoloV3`` are the port's models with every width divided by 8
  and one block per stage (their ``forward`` is the full model's), and
  ``flax_narrow_v4``/``flax_narrow_v3`` their flax twins, which call the JAX package's
  stages in ``YoloV4``/``YoloV3``'s order under the same names, so the weight bridge maps
  one onto the other.
- ``spatial_forward`` runs a module height-sharded over S in-process shards
  (``parallel.inference.shard_predict_spatial`` on the CPU).
- ``spatial_worker`` is what each gloo rank of ``test_torch_spatial_train.py`` runs:
  cases of ``torch_parallel_cases`` under ``SpatialDataParallel``, with the control
  that averages the gradients over the space ranks.
"""

import copy

import torch

import torch_parallel_cases as cases


def narrow_v4(classes_num=2):
    """The port's YOLOv4 at 1/8 width, one block per CSP stage."""
    from tmv_tpu_torch.models import yolo_v4 as ty
    from tmv_tpu_torch.models.layers.common import ConvBN, DarknetConv

    class NarrowYoloV4(ty.YoloV4):
        def __init__(self):
            torch.nn.Module.__init__(self)
            self.dtype, self.remat = torch.float32, False
            out = 3 * (5 + classes_num)
            self.ConvBN_0 = ConvBN(3, 4, 3, act="mish")
            self.BlocksLayer_0 = ty.BlocksLayer(4, 8)
            self.BlocksLayer2_0 = ty.BlocksLayer2(8, 16, 1)
            self.BlocksLayer2_1 = ty.BlocksLayer2(16, 32, 1)
            self.BlocksLayer2_2 = ty.BlocksLayer2(32, 64, 1)
            self.BlocksLayer2_3 = ty.BlocksLayer2(64, 128, 1)
            self.LastLayer_0 = ty.LastLayer(128, 64)
            self.LastLayer2_0 = ty.LastLayer2(64, 64, 32)
            self.LastLayer2_1 = ty.LastLayer2(32, 32, 16)
            self.ConvBN_1 = ConvBN(16, 32, 3, act="leaky")
            self.DarknetConv_0 = DarknetConv(32, out, 1)
            self.OutputLayer2_0 = ty.OutputLayer2(16, 32, 32)
            self.DarknetConv_1 = DarknetConv(64, out, 1)
            self.OutputLayer2_1 = ty.OutputLayer2(32, 64, 64)
            self.DarknetConv_2 = DarknetConv(128, out, 1)

    return NarrowYoloV4()


def narrow_v3(classes_num=2):
    """The port's YOLOv3 at 1/8 width, one block per Darknet stage."""
    from tmv_tpu_torch.models import yolo_v3 as t3
    from tmv_tpu_torch.models.layers.common import ConvBN, DarknetConv

    class NarrowBody(t3.DarknetBody):
        def __init__(self):
            torch.nn.Module.__init__(self)
            self.remat = False
            self.ConvBN_0 = ConvBN(3, 4, 3, act="leaky")
            for k, (cin, f) in enumerate(((4, 8), (8, 16), (16, 32), (32, 64), (64, 128))):
                setattr(self, f"ResblockBody_{k}", t3.ResblockBody(cin, f, 1))

    class NarrowYoloV3(t3.YoloV3):
        def __init__(self):
            torch.nn.Module.__init__(self)
            self.dtype, self.remat = torch.float32, False
            out = 3 * (5 + classes_num)
            self.DarknetBody_0 = NarrowBody()
            self.LastLayers_0 = t3.LastLayers(128, 64)
            self.DarknetConv_0 = DarknetConv(128, out, 1)
            self.ConvBN_0 = ConvBN(64, 32, 1, act="leaky")
            self.LastLayers_1 = t3.LastLayers(32 + 64, 32)
            self.DarknetConv_1 = DarknetConv(64, out, 1)
            self.ConvBN_1 = ConvBN(32, 16, 1, act="leaky")
            self.LastLayers_2 = t3.LastLayers(16 + 32, 16)
            self.DarknetConv_2 = DarknetConv(32, out, 1)

    return NarrowYoloV3()


def flax_narrow_v4(classes_num=2):
    """The flax twin of ``narrow_v4``: ``tmv_tpu.models.yolo_v4.YoloV4``'s call order."""
    from flax import linen as nn

    from tmv_tpu.models import yolo_v4 as fy
    from tmv_tpu.models.layers.common import ConvBN, DarknetConv

    class FlaxNarrowYoloV4(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            out = 3 * (5 + classes_num)
            x = ConvBN(4, 3, act="mish")(x, train)
            x = fy.BlocksLayer(8, name="BlocksLayer_0")(x, train)
            x = fy.BlocksLayer2(16, 1, name="BlocksLayer2_0")(x, train)
            y3 = x = fy.BlocksLayer2(32, 1, name="BlocksLayer2_1")(x, train)
            y2 = x = fy.BlocksLayer2(64, 1, name="BlocksLayer2_2")(x, train)
            y1 = fy.BlocksLayer2(128, 1, name="BlocksLayer2_3")(x, train)
            y1 = fy.LastLayer(64, name="LastLayer_0")(y1, train)
            y2 = fy.LastLayer2(32, name="LastLayer2_0")(y1, y2, train)
            y3 = fy.LastLayer2(16, name="LastLayer2_1")(y2, y3, train)
            z3 = DarknetConv(out, 1)(ConvBN(32, 3, act="leaky")(y3, train))
            z2, y2 = fy.OutputLayer2(32, name="OutputLayer2_0")(y3, y2, train)
            z2 = DarknetConv(out, 1)(z2)
            z1, _ = fy.OutputLayer2(64, name="OutputLayer2_1")(y2, y1, train)
            return DarknetConv(out, 1)(z1), z2, z3

    return FlaxNarrowYoloV4()


def flax_narrow_v3(classes_num=2):
    """The flax twin of ``narrow_v3``: ``tmv_tpu.models.yolo_v3.YoloV3``'s call order."""
    import jax.numpy as jnp
    from flax import linen as nn

    from tmv_tpu.models import yolo_v3 as f3
    from tmv_tpu.models.layers.common import ConvBN, DarknetConv, upsample2x

    class FlaxNarrowBody(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            x = ConvBN(4, 3, act="leaky")(x, train)
            x = f3.ResblockBody(8, 1, name="ResblockBody_0")(x, train)
            x = f3.ResblockBody(16, 1, name="ResblockBody_1")(x, train)
            y3 = x = f3.ResblockBody(32, 1, name="ResblockBody_2")(x, train)
            y2 = x = f3.ResblockBody(64, 1, name="ResblockBody_3")(x, train)
            return f3.ResblockBody(128, 1, name="ResblockBody_4")(x, train), y2, y3

    class FlaxNarrowYoloV3(nn.Module):
        @nn.compact
        def __call__(self, x, train: bool = False):
            out = 3 * (5 + classes_num)
            y1, y2, y3 = FlaxNarrowBody(name="DarknetBody_0")(x, train)
            x, h1 = f3.LastLayers(64, name="LastLayers_0")(y1, train)
            h1 = DarknetConv(out, 1)(h1)
            x = upsample2x(ConvBN(32, 1, act="leaky")(x, train))
            x, h2 = f3.LastLayers(32, name="LastLayers_1")(jnp.concatenate([x, y2], -1), train)
            h2 = DarknetConv(out, 1)(h2)
            x = upsample2x(ConvBN(16, 1, act="leaky")(x, train))
            _, h3 = f3.LastLayers(16, name="LastLayers_2")(jnp.concatenate([x, y3], -1), train)
            return h1, h2, DarknetConv(out, 1)(h3)

    return FlaxNarrowYoloV3()


def spatial_forward(module, images, shards):
    """``module`` (eval, on the CPU) height-sharded over ``shards`` in-process shards
    on ``images`` (NHWC numpy or tensor) → its outputs, whole."""
    from tmv_tpu_torch.parallel.inference import shard_predict_spatial

    images = torch.as_tensor(images)
    forward = shard_predict_spatial(
        [module] + [copy.deepcopy(module) for _ in range(shards - 1)], ["cpu"] * shards)
    try:
        with torch.no_grad(), cases.threads(2):   # the shards' threads share the cores
            return forward(images)
    finally:
        forward.close()


def flat(outputs):
    """The tensors of a nested tuple of outputs, in order."""
    if isinstance(outputs, (tuple, list)):
        return [t for o in outputs for t in flat(o)]
    return [outputs]


# ------------------------------------------------------------------ ranks

def _averaged_over_space(sp):
    """The control: the gradients averaged over every rank (DDP's default mean),
    where the space ranks' partial sums must be added."""
    sp.grad_divisor = sp.world


def spatial_worker(rank, world, space, names, controls=(), clis=()):
    """The ConvBN stack's eval forward under ``wrap_forward`` on this rank's share of a
    batch, each case of ``names`` under ``SpatialDataParallel(space=space)`` on this
    rank's share (``put_batch``), then each of ``controls`` (``"<case>_averaged"``: the case's
    first step with the gradients averaged over space), then each trainer CLI of ``clis``
    (``(which, argv)``, ``which`` "yolo" or "d0"; its result under ``cli_<which>``) in
    these ranks, as under torchrun."""
    from tmv_tpu_torch.cli import train_efficientdet, train_yolo
    from tmv_tpu_torch.parallel.spatial import SpatialDataParallel

    out = {}
    if names or controls:
        sp = SpatialDataParallel(space=space, devices=["cpu"] * world)
        out["mesh"] = (sp.mesh.data_rank, sp.mesh.space_rank, sp.data_world)
        model = cases.init_convbn().eval()
        images = torch.from_numpy(cases.convbn_batches()[0]["image"])
        with torch.no_grad():
            out["forward"] = sp.wrap_forward(model)(sp.put_batch({"image": images})["image"])
        out.update({name: cases.run_case(name, sp) for name in names})
        for control in controls:
            _averaged_over_space(sp)
            out[control] = cases.run_case(control.rsplit("_", 1)[0], sp, steps=1)
            sp.grad_divisor = sp.data_world
    for which, argv in clis:
        out[f"cli_{which}"] = {"yolo": train_yolo, "d0": train_efficientdet}[which].main(argv)
    return out if rank == 0 else cases._digests_only(out)


def _rank_main(rank, world, port, out_dir, threads, args):
    import torch.distributed as dist

    from tmv_tpu_torch.parallel.mesh import init_process_group

    torch.set_num_threads(threads)
    init_process_group(["cpu"] * world, rank, world, f"tcp://localhost:{port}")
    try:
        torch.save(spatial_worker(rank, world, *args), f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


class Ranks(cases.Ranks):
    """``spatial_worker(rank, world, *args)`` in ``world`` gloo CPU ranks (as
    ``torch_parallel_cases.Ranks``)."""

    def __init__(self, world, out_dir, *args, threads=2):
        import os

        import torch.multiprocessing as mp

        from tmv_tpu_torch.parallel.mesh import free_port

        self.world, self.out_dir = world, str(out_dir)
        policy = os.environ.get("OMP_WAIT_POLICY")
        os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
        try:
            self.context = mp.start_processes(
                _rank_main, args=(world, free_port(), self.out_dir, threads, args),
                nprocs=world, join=False, start_method="spawn")
        finally:
            if policy is None:
                del os.environ["OMP_WAIT_POLICY"]
            else:
                os.environ["OMP_WAIT_POLICY"] = policy

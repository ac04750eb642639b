"""Data-parallel cases of the port, shared by the one-process references and the ranks.

Each ``*_case`` builds, from seeds, a fresh train state, its step and a global batch
at the sizes of ``tests/dp_equiv_cases.py`` (YOLOv3 @64 B8, FaceNet RepVGG @64 B8,
MoCo @32 B8; D0 @64 B4). ``run_case`` runs a case in one process on the whole batch,
or under a data-parallel wrapper on this rank's rows, and returns what the tests
compare: the metrics of each step and the module's ``state_dict`` (plus MoCo's
queue). Torch only: the ranks import no JAX.
"""

import contextlib
import hashlib

import numpy as np
import pytest
import torch

COCO_ANCHORS = np.array([[[116, 90], [156, 198], [373, 326]], [[30, 61], [62, 45], [59, 119]],
                         [[10, 13], [16, 30], [33, 23]]], np.float32)


def _images(rng, b, size):
    return torch.from_numpy(rng.uniform(size=(b, size, size, 3)).astype(np.float32))


def yolo_case(accum_steps=1):
    """YOLOv3 (2 classes) @64 B8, real grid targets, the shadow loss, SGD 1e-3."""
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.data.yolo_targets import make_yolo_targets
    from tmv_tpu_torch.models.detector_harness import build_yolo_model, make_yolo_loss_fn
    from tmv_tpu_torch.models.layers.common import init_weights

    rng = np.random.default_rng(0)
    size, b, c = 64, 8, 2
    anchors = COCO_ANCHORS * size / 416
    model, _ = build_yolo_model("v3", c, 3, device="cpu")
    init_weights(model, 0)
    state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    boxes = np.zeros((b, 4, 4), np.float32)
    classes = np.zeros((b, 4), np.int64)
    valid = np.zeros((b, 4), bool)
    for i in range(b):
        for j in range(1 + i % 3):
            x1, y1 = rng.uniform(2, size - 30, 2)
            w, h = rng.uniform(8, 24, 2)
            boxes[i, j] = [x1, y1, x1 + w, y1 + h]
            classes[i, j] = i % c
            valid[i, j] = True
    targets = make_yolo_targets(torch.from_numpy(boxes), torch.from_numpy(classes),
                                torch.from_numpy(valid), anchors, (size, size), c)
    batch = {"image": _images(rng, b, size), "targets": tuple(targets)}
    step = make_train_step(make_yolo_loss_fn((size, size), anchors), shadow_loss=True,
                           accum_steps=accum_steps)
    return state, step, [batch], accum_steps


def d0_case(size=64, batch_size=4, steps=1):
    """EfficientDet-D0 (2 classes + background) @``size``, targets of random boxes,
    the trainer's step: SGD momentum 0.9 on its schedule, clip 10, EMA, the heads'
    ``drop_connect`` fed a generator every rank holds."""
    from tmv_tpu_torch.core.schedules import cosine_lr_schedule
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet
    from tmv_tpu_torch.models.efficientdet.net import init_weights, make_efficientdet_loss_fn

    rng = np.random.default_rng(1)
    model, anchors = build_efficientdet("efficientdet-d0", 3, size, device="cpu")
    init_weights(model, 0)
    schedule = cosine_lr_schedule(0.08, 0.008, 2, 10)
    state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=float(schedule(0)),
                                                     momentum=0.9), ema_decay=0.9998)
    generator = torch.Generator().manual_seed(5)
    batches = []
    for _ in range(steps):
        boxes = np.zeros((batch_size, 3, 4), np.float32)
        for i in range(batch_size):
            y1, x1 = rng.uniform(0, size * 0.5, 2)
            hw = rng.uniform(size * 0.25, size * 0.5, 2)
            boxes[i] = [y1, x1, y1 + hw[0], x1 + hw[1]]
        classes = torch.from_numpy(rng.integers(1, 3, (batch_size, 3)))
        valid = torch.from_numpy(np.arange(3)[None, :] <= np.arange(batch_size)[:, None] % 3)
        boxes_t, classes_t, masks_t = anchors.generate_targets(torch.from_numpy(boxes), classes,
                                                               3, valid)
        batches.append({"image": _images(rng, batch_size, size), "boxes": tuple(boxes_t),
                        "classes": tuple(classes_t), "masks": tuple(masks_t)})
    step = make_train_step(make_efficientdet_loss_fn(generator=generator), clip_global_norm=10.0,
                           ema_decay=0.9998, lr_schedule=schedule)

    def seeded_step(state, batch):
        generator.manual_seed(100 + state.step)
        return step(state, batch)

    return state, seeded_step, batches, 1


def facenet_case():
    """FaceNet RepVGG-B2g4 (embedding 32) @64 B8, the triplet step with ``valid``."""
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step
    from tmv_tpu_torch.models.facenet.model import (
        FaceNetModel, init_weights, make_triplet_train_step,
    )

    rng = np.random.default_rng(0)
    size, b = 64, 8
    model = FaceNetModel(32, backbone="RepVGG", device="cpu")
    init_weights(model, 0)
    state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    batch = {k: _images(rng, b, size) for k in ("anchor", "positive", "negative")}
    batch["valid"] = torch.from_numpy(np.arange(b) % 4 != 3)
    return state, make_train_step(make_triplet_train_step(alpha=0.2)), [batch], 1


def moco_case():
    """MoCo on ResNetYoloV3 (6 filters) @32 B8, queue 4·B, two steps of SGD 1e-3."""
    from tmv_tpu_torch.core.train_state import TrainState
    from tmv_tpu_torch.models.layers.common import init_weights
    from tmv_tpu_torch.models.moco import (
        ResNetYoloV3, flatten_normalize, init_moco_state, make_moco_train_step,
    )

    rng = np.random.default_rng(0)
    size, b = 32, 8
    model = ResNetYoloV3(6, device="cpu")
    init_weights(model, 0)
    model.eval()
    with torch.no_grad():
        feat = flatten_normalize(model(torch.zeros(1, size, size, 3))).shape[-1]
    extra = init_moco_state(model, 4 * b, feat, generator=torch.Generator().manual_seed(7))
    state = TrainState.create(model, torch.optim.SGD(model.parameters(), lr=1e-3), extra=extra)
    batches = [{"query": _images(rng, b, size), "key": _images(rng, b, size)} for _ in range(2)]
    return state, make_moco_train_step(), batches, 1


class ConvBNStack(torch.nn.Module):
    """Two ConvBN (leaky) layers, 3 → 16 → 32 channels (the second stride 2), NHWC in
    and out; the flax names of ``ConvBN_0``/``ConvBN_1`` in a flax module."""

    def __init__(self):
        from tmv_tpu_torch.models.layers.common import ConvBN

        super().__init__()
        self.ConvBN_0 = ConvBN(3, 16, 3)
        self.ConvBN_1 = ConvBN(16, 32, 3, strides=2)

    def forward(self, x):
        return self.ConvBN_1(self.ConvBN_0(x.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)


def init_convbn(seed=0):
    from tmv_tpu_torch.models.layers.common import init_weights

    return init_weights(ConvBNStack(), seed)


def convbn_batches(steps=2, b=8):
    """``steps`` batches of 16 × 16 images and 8 × 8 × 32 targets, numpy, seeded."""
    rng = np.random.default_rng(3)
    return [{"image": rng.uniform(size=(b, 16, 16, 3)).astype(np.float32),
             "target": rng.normal(size=(b, 8, 8, 32)).astype(np.float32)}
            for _ in range(steps)]


def convbn_loss(model, batch):
    return torch.mean(torch.square(model(batch["image"]) - batch["target"])), {}


def convbn_case(optimizer="sgd"):
    """The stack (seed 0) for two steps: ``sgd`` is SGD 0.1 (held against JAX);
    ``momentum`` SGD 0.05 with momentum 0.9, a weight EMA and the shadow loss (the
    checkpoint cases); ``adam`` Adam 1e-3 with the EMA (the storage case)."""
    from tmv_tpu_torch.core.train_state import TrainState, make_train_step

    model = init_convbn()
    ema = None if optimizer == "sgd" else 0.999
    opt = {"sgd": lambda p: torch.optim.SGD(p, lr=0.1),
           "momentum": lambda p: torch.optim.SGD(p, lr=0.05, momentum=0.9),
           "adam": lambda p: torch.optim.Adam(p, lr=1e-3)}[optimizer](model.parameters())
    state = TrainState.create(model, opt, ema_decay=ema)
    step = make_train_step(convbn_loss, shadow_loss=optimizer != "sgd", ema_decay=ema)
    batches = [{k: torch.from_numpy(v) for k, v in b.items()} for b in convbn_batches()]
    return state, step, batches, 1


CASES = {"yolo": yolo_case, "yolo_accum": lambda: yolo_case(accum_steps=2), "d0": d0_case,
         "facenet": facenet_case, "moco": moco_case, "convbn": convbn_case,
         "convbn_momentum": lambda: convbn_case("momentum"),
         "convbn_adam": lambda: convbn_case("adam"), "d0_tiny": lambda: d0_case(32, 8)}


def snapshot(state, metrics):
    """What a test compares after a step: its metrics and the module's ``state_dict``
    (and MoCo's queue, pointer and key tower), whole and on the CPU, with a digest of
    each ``state_dict`` entry."""
    full = getattr(state.parallel, "full_state", None)
    model = full(state)["model"] if full is not None else state.model.state_dict()
    model = {k: v.detach().clone().cpu() for k, v in model.items()}
    out = {"metrics": {k: float(v) for k, v in metrics.items()}, "model": model,
           "digest": {k: hashlib.sha256(v.numpy().tobytes()).hexdigest()
                      for k, v in model.items()}}
    if state.extra is not None:
        out["queue"] = state.extra.queue.detach().clone().cpu()
        out["queue_ptr"] = state.extra.queue_ptr
        out["key_model"] = {k: v.detach().clone().cpu()
                            for k, v in state.extra.key_model.state_dict().items()}
    return out


def run_case(name, wrapper=None, steps=None):
    """Case ``name`` in one process (``wrapper`` None) or under ``wrapper``
    (``DataParallel``/``FullyShardedDataParallel``) on this rank's rows; a
    ``snapshot`` after each step (of the first ``steps`` where given)."""
    torch.manual_seed(0)
    state, step, batches, accum = CASES[name]()
    batches = batches[:steps]
    if wrapper is not None:
        state = wrapper.put_state(state)
        step = wrapper.wrap_step(step)
        batches = [wrapper.put_batch(b, accum_steps=accum) for b in batches]
    return [snapshot(state, step(state, b)) for b in batches]


# ------------------------------------------------------------------ checks

def floats(state):
    return {k: v for k, v in state.items() if v.is_floating_point()}


def within(ref, got, loss_rel, rtol, atol):
    """True where the loss and every float entry of the state agree."""
    loss_ok = got["metrics"]["loss"] == pytest.approx(ref["metrics"]["loss"], rel=loss_rel)
    state_ok = all(torch.allclose(got["model"][k], v, rtol=rtol, atol=atol)
                   for k, v in floats(ref["model"]).items())
    return loss_ok and state_ok


def check_ranks_hold_one_state(results, name):
    """After DDP's averaged update every rank holds the same parameters, bit for bit
    (equal digests); the global BatchNorm gives every rank the same running statistics
    (a rank-local control's statistics differ, its parameters do not)."""
    rank0, rank1 = (r[name][-1] for r in results)
    for key, digest in rank0["digest"].items():
        if not (name == "yolo_local_bn" and "running" in key):
            assert digest == rank1["digest"][key], key
    assert rank0["metrics"] == rank1["metrics"]


def check_dp_step_equals_the_one_process_step(ref, got):
    """Loss within rel 2e-3, every parameter and running statistic within rtol 1e-3,
    atol 5e-4 (``case_yolo``'s tolerances; a mis-sharding moves parameters by the whole
    update, 5e-3 to 1.5e-2)."""
    assert got["metrics"]["loss"] == pytest.approx(ref["metrics"]["loss"], rel=2e-3)
    for key, value in floats(ref["model"]).items():
        torch.testing.assert_close(got["model"][key], value, rtol=1e-3, atol=5e-4, msg=key)


def check_control_fails_the_tolerance(ref, got):
    """The control's step leaves ``check_dp_step_equals_the_one_process_step``'s
    tolerance, and so do its parameters alone."""
    assert not within(ref, got, 2e-3, 1e-3, 5e-4)
    params = {k for k in floats(ref["model"]) if "running" not in k}
    assert not all(torch.allclose(got["model"][k], ref["model"][k], rtol=1e-3, atol=5e-4)
                   for k in params)


# ------------------------------------------------------------------ ranks

def _rank_main(rank, world, port, fn_name, out_dir, threads, args):
    import torch.distributed as dist

    from tmv_tpu_torch.parallel.mesh import init_process_group

    torch.set_num_threads(threads)
    init_process_group(["cpu"] * world, rank, world, f"tcp://localhost:{port}")
    try:
        result = globals()[fn_name](rank, world, *args)
        torch.save(result, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


class Ranks:
    """``fn_name(rank, world, *args)`` of this module in ``world`` gloo CPU ranks of
    ``threads`` CPU threads each, started now (start method ``spawn``, OpenMP told not
    to spin while it waits, so that the ranks and this process share the cores);
    ``results()`` waits and returns each rank's return value, in rank order."""

    def __init__(self, fn_name, world, out_dir, *args, threads=2):
        import os

        import torch.multiprocessing as mp

        from tmv_tpu_torch.parallel.mesh import free_port

        self.world, self.out_dir = world, str(out_dir)
        policy = os.environ.get("OMP_WAIT_POLICY")
        os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
        try:
            self.context = mp.start_processes(
                _rank_main, args=(world, free_port(), fn_name, self.out_dir, threads, args),
                nprocs=world, join=False, start_method="spawn")
        finally:
            if policy is None:
                del os.environ["OMP_WAIT_POLICY"]
            else:
                os.environ["OMP_WAIT_POLICY"] = policy

    def results(self):
        import os

        while not self.context.join():
            pass
        out = []
        for r in range(self.world):   # read, then removed: a snapshot may be 300 MB
            out.append(torch.load(f"{self.out_dir}/rank{r}.pt", weights_only=False))
            os.remove(f"{self.out_dir}/rank{r}.pt")
        return out


def _local_batchnorm():
    """The BatchNorms' statistics rank-local (a control that must fail)."""
    import tmv_tpu_torch.models.layers.common as common

    common.data_group = lambda: None


def _local_positives():
    """D0's ``num_positives`` rank-local (a control that must fail)."""
    import tmv_tpu_torch.models.efficientdet.net as net

    net.global_sum = lambda t: t.detach()


def mesh_checks(rank, world):
    """This rank's ``shard_batch`` of rows 0..7 (and with 2 micro-batches), and a
    rank-dependent module and dict after ``replicate``."""
    from tmv_tpu_torch.parallel import create_mesh, replicate, shard_batch

    mesh, _ = create_mesh(world, ("data",), devices=["cpu"] * world)
    rows = {"x": torch.arange(8), "y": (np.arange(8) * 10,)}
    module = torch.nn.BatchNorm2d(3)
    with torch.no_grad():
        module.weight.fill_(rank + 1.0)
        module.running_mean.fill_(rank + 2.0)
    tensors = {"a": torch.full((3,), float(rank)), "b": [torch.full((2,), rank + 5.0)]}
    replicate(module, mesh)
    replicate(tensors, mesh)
    return {"shard": shard_batch(rows, mesh), "accum": shard_batch(rows, mesh, accum_steps=2),
            "module": module.state_dict(), "tensors": tensors}


def _digests_only(obj):
    """``obj`` with each snapshot's tensors dropped (their digests kept)."""
    if isinstance(obj, dict) and "digest" in obj:
        return {k: v for k, v in obj.items() if k not in ("model", "key_model", "queue")}
    if isinstance(obj, dict):
        return {k: _digests_only(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_digests_only(v) for v in obj]
    return obj


def paths_worker(rank, world, names, controls=(), cli=None):
    """The mesh checks; each case of ``names`` under ``DataParallel``; then the
    ``controls`` (``yolo_local_bn``, ``d0_local_positives``); then, given ``cli``
    (``(files, root)``), ``d0_cli``."""
    from tmv_tpu_torch.parallel import DataParallel

    dp = DataParallel(devices=["cpu"] * world)
    out = {"mesh": mesh_checks(rank, world)}
    out.update({name: run_case(name, dp) for name in names})
    out.update(run_controls(dp, controls))
    if cli is not None:
        out["d0_cli"] = d0_cli(*cli)
    return out if rank == 0 else _digests_only(out)   # rank 0's tensors are compared


def run_controls(dp, controls):
    """The ``controls`` under ``dp``: ``yolo_local_bn``, ``d0_local_positives``."""
    out = {}
    if "yolo_local_bn" in controls:
        import tmv_tpu_torch.models.layers.common as common

        global_stats = common.data_group
        _local_batchnorm()
        out["yolo_local_bn"] = run_case("yolo", dp)
        common.data_group = global_stats
    if "d0_local_positives" in controls:
        import tmv_tpu_torch.models.efficientdet.net as net

        global_positives = net.global_sum
        _local_positives()
        out["d0_local_positives"] = run_case("d0", dp)
        net.global_sum = global_positives
    return out


def storage(state):
    """Per parameter name: (its elements, this rank's elements, the sharded dim or
    None) of the parameter, its optimizer state and its EMA mirror."""
    from torch.distributed.tensor import DTensor

    def one(t):
        if isinstance(t, DTensor):
            return t.numel(), t.to_local().numel(), t.placements[0].dim
        return t.numel(), t.numel(), None

    out = {}
    for name, p in state.model.named_parameters():
        moments = {k: one(v) for k, v in state.optimizer.state[p].items() if v.dim()}
        ema = None if state.ema_params is None else one(state.ema_params[name])
        out[name] = {"param": one(p), "moments": moments, "ema": ema}
    return out


def fsdp_worker(rank, world, root, names, controls=()):
    """``names`` and ``controls`` under ``DataParallel``; the ConvBN stack's two SGD
    steps under DP and
    under FSDP (``min_size`` 32: the first BatchNorm stays replicated); FSDP's
    ``wrap_forward`` of the stack beside its plain forward; FSDP's storage under Adam
    with the EMA; checkpoints: DP and FSDP each save after two steps of
    SGD with momentum, the EMA and the shadow loss; the FSDP one restored into a plain
    template and resharded for a third step; the DP one resumed under FSDP and under
    DP for a third step."""
    from tmv_tpu_torch.core.checkpoint import CheckpointManager
    from tmv_tpu_torch.parallel import DataParallel, FullyShardedDataParallel

    dp = DataParallel(devices=["cpu"] * world)
    fsdp = FullyShardedDataParallel(devices=["cpu"] * world, min_size=32)
    out = {name: run_case(name, dp) for name in names}
    out.update(run_controls(dp, controls))
    out["convbn_dp"] = run_case("convbn", dp)
    out["convbn_fsdp"] = run_case("convbn", fsdp)

    model = init_convbn().eval()
    images = torch.from_numpy(convbn_batches()[0]["image"])
    with torch.no_grad():
        out["forward"] = (model(images), fsdp.wrap_forward(model)(images))

    state, step, batches, _ = convbn_case("adam")
    fsdp.put_state(state)
    fsdp.wrap_step(step)(state, fsdp.put_batch(batches[0]))
    out["storage"] = storage(state)
    out["shadow_loss"] = state.shadow_loss.detach().cpu()

    def trained(wrapper, directory):
        state, step, batches, _ = convbn_case("momentum")
        wrapper.put_state(state)
        step = wrapper.wrap_step(step)
        for b in batches:
            step(state, wrapper.put_batch(b))
        mgr = CheckpointManager(directory)
        mgr.save(state.step, state)
        mgr.close()
        return state, step, batches

    def third_step(wrapper, directory):
        state, step, batches, _ = convbn_case("momentum")
        CheckpointManager(directory).restore(state)
        wrapper.put_state(state)
        metrics = wrapper.wrap_step(step)(state, wrapper.put_batch(batches[0]))
        return snapshot(state, metrics) | {"step": state.step}

    trained(dp, f"{root}/dp")
    fsdp_state, _, _ = trained(fsdp, f"{root}/fsdp")
    out["fsdp_live"] = snapshot(fsdp_state, {})
    out["fsdp_roundtrip"] = third_step(fsdp, f"{root}/fsdp")
    out["dp_resumed_fsdp"] = third_step(fsdp, f"{root}/dp")
    out["dp_resumed_dp"] = third_step(dp, f"{root}/dp")
    return out


def dryrun_worker(rank, world):
    """A tiny D0 (32 px, B8) train step under DP and under FSDP."""
    from tmv_tpu_torch.parallel import DataParallel, FullyShardedDataParallel

    dp = DataParallel(devices=["cpu"] * world)
    fsdp = FullyShardedDataParallel(devices=["cpu"] * world)
    return {"dp": run_case("d0_tiny", dp), "fsdp": run_case("d0_tiny", fsdp)}


def d0_cli(files, root):
    """``train_efficientdet --dp`` in the ranks that call it, as under torchrun (D0
    @32, ``--deviceAug``, global B4, one step) on ``files`` (``write_tiny_set``'s)."""
    from tmv_tpu_torch.cli import train_efficientdet

    return train_efficientdet.main([
        "--trainData", files["labels"], "--trainImagePath", files["images"], "--classesFile",
        files["classes"], "--imageSize", "32", "--batchSize", "4", "--stepsPerEpoch", "1",
        "--epochs", "1", "--device", "cpu", "--modelName", "efficientdet-d0", "--deviceAug",
        "--modelPath", f"{root}/d0", "--dp"])


@contextlib.contextmanager
def threads(n):
    """This process's torch CPU threads capped at ``n`` for the block."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, n))
    try:
        yield
    finally:
        torch.set_num_threads(before)

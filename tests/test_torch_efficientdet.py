"""The port's EfficientDet-D0 modules against the JAX package, on the CPU.

Each flax module is built with ``jax.eval_shape`` and filled from a seed
(``torch_port_cases.seeded_variables``, non-trivial BatchNorm statistics), the
same tree is bridged into the port's module with ``flax_to_state_dict``, and both
run the same numpy inputs in float32. Tolerance: max|port − JAX| ≤
1e-5·max|JAX| per output (sums are taken in another order; measured ~1e-6).

- ``MBConvBlock`` in eval against the flax block with ``fused_dw_eval=True`` (the
  Pallas kernel in interpret mode) and ``False``; in train mode against flax's
  batch-statistics path. Every eval block goes through ``fused_dw_bn_swish``
  (16 calls per D0 forward), no train block does.
- ``BiFPN`` with each of the five weight methods, at pyramid sizes 10/5/3/2/1,
  which need the asymmetric -inf max-pool pad and nearest resizes at ratios other
  than 2 (where ``"nearest"`` and JAX's half-pixel ``"nearest"`` differ).
- ``ClassNet`` / ``BoxNet`` with ``survival_prob`` 0.8: the residual is added in
  eval too; ``drop_connect`` acts in training only.
- The whole ``EfficientDetNet`` at D0 width and depth (81 classes) at 64 and 80.
- The bridge consumes every leaf of the D0 tree (709) exactly once.
- The port's server with ``--family efficientdet`` answers the reference's
  contract on the CPU, refuses the int8 flags as the JAX server does (int8 serving
  is YOLO-family) and the unported flags by name.
"""

import base64
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

from tmv_tpu.models.efficientdet import EfficientDetNet as FlaxEfficientDetNet
from tmv_tpu.models.efficientdet.backbone import MBConvBlock as FlaxMBConvBlock
from tmv_tpu.models.efficientdet.bifpn import BiFPN as FlaxBiFPN
from tmv_tpu.models.efficientdet.bifpn import ResampleFeatureMap as FlaxResample
from tmv_tpu.models.efficientdet.config import default_blocks_args
from tmv_tpu.models.efficientdet.heads import BoxNet as FlaxBoxNet
from tmv_tpu.models.efficientdet.heads import ClassNet as FlaxClassNet
from tmv_tpu_torch.cli import serve
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.kernels.dwconv import fused_dw_bn_swish
from tmv_tpu_torch.models.efficientdet import backbone
from tmv_tpu_torch.models.efficientdet.backbone import MBConvBlock
from tmv_tpu_torch.models.efficientdet.bifpn import WEIGHT_METHODS, BiFPN, ResampleFeatureMap
from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet, efficientdet_config
from tmv_tpu_torch.models.efficientdet.heads import BoxNet, ClassNet, draw_uniform, drop_connect
from tmv_tpu_torch.models.efficientdet.net import EfficientDetNet
from torch_port_cases import flax_leaf_count, one_torch_thread, seeded_variables  # noqa: F401

LEVELS_80 = (10, 5, 3, 2, 1)


def seeded(flax_module, *inputs, seed=0, **kw):
    """numpy variables of ``flax_module`` (eval_shape, then seeded), with the
    BiFPN fusion weights in [0.5, 1.5] so that ``Σw + 1e-4`` stays away from 0."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: flax_module.init(jax.random.key(0), *inputs, **kw))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))

    def fix(path, leaf):
        if path[-1].key.startswith("WSM_"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fix, variables)


def bridged(module, variables):
    module.load_state_dict(flax_to_state_dict(variables, module), strict=True)
    return module


def nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def running_stats(params, batch_stats):
    """The ``running_mean`` / ``running_var`` entries of the bridged flax tree."""
    state = flax_to_state_dict(jax.tree.map(np.asarray, {"params": params,
                                                         "batch_stats": batch_stats}))
    return {k: v for k, v in state.items() if k.endswith(("running_mean", "running_var"))}


def assert_stats_close(got, want, key):
    """A running statistic within 1e-6 of the tensor's largest entry (relative)."""
    got, want = got.numpy(), want.numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), (key, np.abs(got - want).max())


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), \
        (np.abs(got - want).max(), np.abs(want).max())


BLOCKS = [(0, 16), (1, 16), (2, 15)]     # (B0 block-args index, input H=W)


@pytest.mark.parametrize("fused", [True, False], ids=["fused_dw_eval", "xla_dw"])
@pytest.mark.parametrize("block, size", BLOCKS, ids=[f"b{i}_{s}" for i, s in BLOCKS])
def test_mbconv_eval_matches_flax(rng, monkeypatch, block, size, fused):
    args = default_blocks_args()[block]._replace(num_repeat=1)
    x = rng.normal(size=(2, size, size, args.input_filters)).astype(np.float32)
    flax_block = FlaxMBConvBlock(args, fused_dw_eval=fused)
    variables = seeded(flax_block, jnp.asarray(x), False)
    want = flax_block.apply(variables, jnp.asarray(x), False)
    calls = []

    def counted(*a):
        calls.append(a[-1])
        return fused_dw_bn_swish(*a)

    monkeypatch.setattr(backbone, "fused_dw_bn_swish", counted)
    block_t = bridged(MBConvBlock(args), variables).eval()
    with torch.no_grad():
        got = block_t(nchw(x))
    assert calls == [args.strides[0]]
    assert_close(nhwc(got), want)


def test_mbconv_train_mode_uses_batch_statistics_without_the_kernel(rng, monkeypatch):
    args = default_blocks_args()[1]._replace(num_repeat=1)
    x = rng.normal(size=(3, 12, 12, args.input_filters)).astype(np.float32)
    flax_block = FlaxMBConvBlock(args)
    variables = seeded(flax_block, jnp.asarray(x), False)
    want, mutated = flax_block.apply(variables, jnp.asarray(x), True, mutable=["batch_stats"])
    monkeypatch.setattr(backbone, "fused_dw_bn_swish", None)   # must not be called
    block_t = bridged(MBConvBlock(args), variables).train()
    with torch.no_grad():
        got = block_t(nchw(x))
    assert_close(nhwc(got), want)
    # the running statistics move as flax's do (biased batch variance)
    stats = running_stats(variables["params"], mutated["batch_stats"])
    state = block_t.state_dict()
    assert len(stats) == 3 * 2
    for key, value in stats.items():
        assert_stats_close(state[key], value, key)


def test_d0_train_forward_updates_batch_statistics_as_flax(one_torch_thread):
    """One train-mode forward of the whole D0 at 64 px, B = 2, in float64 on both
    sides (the forward's float32 rounding, amplified by batch statistics over as
    few as 2 values, would hide the update's arithmetic): every BatchNorm's
    running mean and variance (backbone, resamples, BiFPN, the heads' per-level
    ones) equals flax's mutated ``batch_stats`` within 1e-6 of its largest entry.
    ``nn.BatchNorm2d`` would blend in the unbiased batch variance: n/(n−1) off,
    twice the value at the 1 × 1 P7 level. ``survival_prob`` is 1, so that the
    heads' statistics do not depend on the two packages' drop_connect draws."""
    cfg = efficientdet_config("efficientdet-d0", 81, 64)
    cfg.fused_dw_eval = False
    cfg.survival_prob = 1.0
    variables = seeded(FlaxEfficientDetNet(config=cfg), jnp.zeros((1, 64, 64, 3)),
                       train=False, seed=64)
    images = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3))
    with jax.enable_x64(True):
        flax_model = FlaxEfficientDetNet(config=cfg, dtype=jnp.float64)
        cast = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        _, mutated = jax.jit(lambda v, x: flax_model.apply(
            v, x, train=True, mutable=["batch_stats"], rngs={"dropout": jax.random.key(0)}))(
            cast, jnp.asarray(images))
        mutated = jax.tree.map(np.asarray, mutated)
    net = bridged(EfficientDetNet(cfg, dtype=torch.float64, device="cpu"), variables)
    net = net.to(torch.float64).train()
    with torch.no_grad():
        net(torch.from_numpy(images), generator=torch.Generator().manual_seed(0))
    want = running_stats(variables["params"], mutated["batch_stats"])
    state = net.state_dict()
    assert len(want) == 2 * sum(isinstance(m, torch.nn.BatchNorm2d) for m in net.modules())
    for key, value in want.items():
        assert_stats_close(state[key], value, key)


def test_resample_hazards_match_flax(rng):
    """3 → 5 nearest upsample and 10 → 5 SAME max-pool (pads (0, 1), with -inf)."""
    for size, target in ((3, 5), (10, 5)):
        x = rng.normal(size=(2, size, size, 16)).astype(np.float32) - 3.0
        want = FlaxResample(16, target).apply({}, jnp.asarray(x))
        with torch.no_grad():
            got = ResampleFeatureMap(16, 16, target)(nchw(x))
        np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    # the hazard is real: torch's plain "nearest" picks other source rows at 3 → 5
    x = torch.arange(3.0).view(1, 1, 3, 1)
    assert not torch.equal(F.interpolate(x, size=(5, 1), mode="nearest"),
                           F.interpolate(x, size=(5, 1), mode="nearest-exact"))


@pytest.mark.parametrize("method", WEIGHT_METHODS)
def test_bifpn_matches_flax(rng, method):
    channels = (8, 12, 16, 16, 16)
    inputs = [rng.normal(size=(2, s, s, c)).astype(np.float32)
              for s, c in zip(LEVELS_80, channels)]
    flax_cell = FlaxBiFPN(16, LEVELS_80, weight_method=method)
    variables = seeded(flax_cell, [jnp.asarray(i) for i in inputs], False)
    want = flax_cell.apply(variables, [jnp.asarray(i) for i in inputs], False)
    cell = bridged(BiFPN(16, LEVELS_80, channels, method), variables).eval()
    with torch.no_grad():
        got = cell([nchw(i) for i in inputs])
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert_close(nhwc(g), w)


@pytest.mark.parametrize("net", ["class", "box"])
def test_heads_match_flax_with_eval_residual(rng, net):
    inputs = [rng.normal(size=(2, s, s, 16)).astype(np.float32) for s in LEVELS_80]
    kw = dict(num_anchors=9, num_filters=16, num_levels=5, repeats=3, survival_prob=0.8)
    if net == "class":
        flax_net, port = FlaxClassNet(num_classes=6, **kw), ClassNet(num_classes=6, **kw)
    else:
        flax_net, port = FlaxBoxNet(**kw), BoxNet(**kw)
    variables = seeded(flax_net, [jnp.asarray(i) for i in inputs], False)
    want = flax_net.apply(variables, [jnp.asarray(i) for i in inputs], False)
    port = bridged(port, variables).eval()
    with torch.no_grad():
        got = port([nchw(i) for i in inputs])
    for g, w in zip(got, want):
        assert_close(g.numpy(), w)


def test_drop_connect_only_in_training(rng):
    inputs = [torch.from_numpy(rng.normal(size=(8, 16, s, s)).astype(np.float32))
              for s in LEVELS_80]
    net = BoxNet(num_anchors=9, num_filters=16, num_levels=5, repeats=2, survival_prob=0.5)
    ones = torch.ones(64, 3, 2, 2)
    keep = drop_connect(ones, 0.5, draw_uniform(ones, torch.Generator().manual_seed(0)))
    assert set(keep.unique().tolist()) == {0.0, 2.0}   # whole samples dropped or x 1/0.5
    with torch.no_grad():
        eval_out = net.eval()(inputs)
        assert all(torch.equal(a, b) for a, b in zip(eval_out, net(inputs)))
        train_out = net.train()(inputs, torch.Generator().manual_seed(1))
        again = net(inputs, torch.Generator().manual_seed(1))
        with pytest.raises(ValueError, match="Generator"):
            net(inputs)
    assert not all(torch.allclose(a, b) for a, b in zip(eval_out, train_out))
    assert all(torch.equal(a, b) for a, b in zip(train_out, again))   # the generator decides


def _d0_pair(size):
    cfg = efficientdet_config("efficientdet-d0", 81, size)
    cfg.fused_dw_eval = False
    flax_model = FlaxEfficientDetNet(config=cfg)
    variables = seeded(flax_model, jnp.zeros((1, size, size, 3)), train=False, seed=size)
    net, _ = build_efficientdet("efficientdet-d0", 81, size, device="cpu")
    return flax_model, variables, bridged(net, variables).eval()


@pytest.mark.parametrize("size", [64, 80])
def test_d0_forward_matches_flax(monkeypatch, size):
    flax_model, variables, net = _d0_pair(size)
    images = np.random.default_rng(size).uniform(0, 1, (2, size, size, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: flax_model.apply(v, x, train=False))(
        variables, jnp.asarray(images))
    calls = []

    def counted(*a):
        calls.append(a[-1])
        return fused_dw_bn_swish(*a)

    monkeypatch.setattr(backbone, "fused_dw_bn_swish", counted)
    with torch.no_grad():
        got = net(torch.from_numpy(images))
    assert len(calls) == 16                       # every MBConv block, once
    assert calls.count(2) == 4
    for g_heads, w_heads in zip(got, want):
        assert len(g_heads) == len(w_heads) == 5
        for g, w in zip(g_heads, w_heads):
            assert_close(g.numpy(), w)
    assert got[1][0].shape == (2, size // 8, size // 8, 9, 81)


def test_bridge_consumes_every_d0_leaf_once():
    _, variables, net = _d0_pair(64)
    state = flax_to_state_dict(variables, net)
    counters = [k for k in state if k.endswith("num_batches_tracked")]
    assert flax_leaf_count(variables) == 709
    assert len(state) - len(counters) == 709
    torch_state = net.state_dict()
    np.testing.assert_array_equal(
        torch_state["backbone.MBConvBlock_1.Conv_1.weight"].numpy(),
        variables["params"]["backbone"]["MBConvBlock_1"]["Conv_1"]["kernel"].transpose(3, 2, 0, 1))
    assert torch_state["backbone.MBConvBlock_1.Conv_1.weight"].shape == (96, 1, 3, 3)
    wsm = variables["params"]["fpn_cell_2"]["BiFPNNode_7"]["WSM_1"]
    assert torch_state["fpn_cell_2.BiFPNNode_7.WSM_1"].shape == ()
    assert float(torch_state["fpn_cell_2.BiFPNNode_7.WSM_1"]) == float(wsm)
    np.testing.assert_array_equal(
        torch_state["class_net.net.bn_2_level_4.running_var"].numpy(),
        variables["batch_stats"]["class_net"]["net"]["bn_2_level_4"]["var"])


def _classes_file(tmp_path):
    path = tmp_path / "classes.txt"
    path.write_text("\n".join(f"class_{i}" for i in range(3)) + "\n")
    return ["--classesFile", str(path), "--family", "efficientdet"]


def _post(app, payload):
    body = json.dumps(payload).encode()
    status = {}

    def start_response(s, headers):
        status["status"] = s

    environ = {"PATH_INFO": "/ai_api/object_detection/predict", "REQUEST_METHOD": "POST",
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    out = b"".join(app(environ, start_response))
    return status["status"], json.loads(out)


@pytest.mark.parametrize("batch", [1, 2])
def test_efficientdet_serve_path_answers_the_reference_contract(tmp_path, rng, batch):
    args = serve.parse_args(_classes_file(tmp_path) + [
        "--modelName", "efficientdet-d0", "--randomInit", "--seed", "0", "--imageSize", "64",
        "--device", "cpu", "--batch", str(batch)])
    app, service, model = serve.build_app(args)
    assert model.config.num_classes == 4 and model.config.levels_size[3] == 8
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)).save(buf, "JPEG")
    data = "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode()
    try:
        for read in (1, 0):
            status, out = _post(app, {"img_data": data, "read": read})
            assert status.startswith("200"), out
            assert set(out) == {"boxes", "classes", "random_img", "result_img"}
            assert len(out["boxes"]) == len(out["classes"])
            assert bool(out["result_img"]) == bool(read)
        assert service.request_count == 2
    finally:
        if service.batcher is not None:
            service.batcher.close()


def test_efficientdet_serve_refuses_unported_flags(tmp_path, capsys):
    base = _classes_file(tmp_path) + ["--randomInit"]
    for extra in (["--int8"], ["--int8Static", "calib"], ["--int8Margin", "0.5"],
                  ["--int8PerChannel"]):
        with pytest.raises(SystemExit):
            serve.parse_args(base + extra)
        assert "int8 serving is yolo-family" in capsys.readouterr().err
    # --spatial is ported, with the JAX server's EfficientDet rules
    assert serve.parse_args(base + ["--spatial", "2"]).spatial == 2
    for extra, why in ((["--spatial", "2", "--batch", "2"], "--spatial is the latency "
                        "direction: --batch 1, no --dp"),
                       (["--spatial", "2", "--imageSize", "417"], "--imageSize 417 is not "
                        "divisible by --spatial 2")):
        with pytest.raises(SystemExit):
            serve.parse_args(base + extra)
        assert why in capsys.readouterr().err
    # --dp is ported, with the JAX server's EfficientDet rule
    with pytest.raises(SystemExit):
        serve.parse_args(base + ["--dp", "2"])
    assert "--dp requires --batch > 1 divisible by it" in capsys.readouterr().err
    assert serve.parse_args(base + ["--dp", "2", "--batch", "16"]).dp == 2
    # --artifact is ported: its program pins the weights --randomInit would make
    with pytest.raises(SystemExit):
        serve.parse_args(base + ["--artifact", "a.tmvt"])
    assert "cannot be combined with --artifact" in capsys.readouterr().err

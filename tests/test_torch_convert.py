"""The port's weight importers (``tmv_tpu_torch.convert.darknet``,
``convert.darknet_cfg``, ``convert.h5_import``, ``cli/convert_darknet.py``)
against the JAX package's, on the CPU. Every comparison is exact: an importer
moves float32 values and changes none.

- A Darknet stream written by JAX's ``save_darknet_weights`` from seeded YOLOv3
  and YOLOv4 trees (64 px trace) loads in the port to exactly the bridged JAX
  load; the port's ``save_darknet_weights`` writes the same bytes, and JAX's
  load of it equals the port's state_dict.
- The traced walk is the call order, not the registration order: 13 sibling
  ConvBNs (two-digit suffixes) registered in reverse walk in call order, each
  conv followed by its BatchNorm, and a stream whose i-th conv is the constant i
  lands in ``ConvBN_i`` (JAX's ``test_many_siblings_walk_in_call_order`` and
  ``test_stream_assignment_by_call_order``). Both header versions load.
- A short stream names the failing conv; a long one reports the unread bytes.
- The cfg of ``tests/test_convert_and_utils.py`` (``TINY_CFG``, copied): the
  parse equals JAX's; ``DarknetCfgNet``'s forward on bridged weights equals the
  flax net's (rtol 1e-5, atol 1e-5·max|ref|); ``load_cfg_weights`` of a stream
  JAX wrote equals JAX's; a wider cfg names the failing conv; an unsupported
  section raises.
- Keras ``.h5``: a file of JAX's ``save_keras_h5_weights`` loads strictly to the
  bridged JAX load, and the port's file loads in JAX; non-strict into a
  5-class head skips exactly JAX's skipped weights (the 6 output-conv tensors)
  and strict raises; unconsumed layers raise.
- ``cli/convert_darknet.py`` writes a step-0 checkpoint directory (from a
  ``.weights`` and from an ``.h5``) that ``cli/serve.py`` serves.
"""

import io
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tmv_tpu.convert import darknet as jax_darknet
from tmv_tpu.convert import darknet_cfg as jax_cfg
from tmv_tpu.convert import h5_import as jax_h5
from tmv_tpu.models.yolo_v3 import YoloV3 as FlaxYoloV3
from tmv_tpu.models.yolo_v4 import YoloV4 as FlaxYoloV4
from tmv_tpu_torch.cli import convert_darknet, serve
from tmv_tpu_torch.convert.darknet import (
    conv_call_order, load_darknet_weights, save_darknet_weights,
)
from tmv_tpu_torch.convert.darknet_cfg import build_from_cfg, load_cfg_weights, parse_darknet_cfg
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.convert.h5_import import load_keras_h5_weights, save_keras_h5_weights
from tmv_tpu_torch.models.layers.common import ConvBN, DarknetConv, init_weights
from tmv_tpu_torch.models.yolo_v3 import YoloV3
from tmv_tpu_torch.models.yolo_v4 import YoloV4
from torch_port_cases import (  # noqa: F401
    answer_one_request, disposable_tmp, seeded_variables, write_yolo_inputs,
)

FLAX = {"v3": FlaxYoloV3, "v4": FlaxYoloV4}
PORT = {"v3": YoloV3, "v4": YoloV4}


def seeded_tree(flax_model, size, seed):
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, size, size, 3)))
    return jax.tree.map(np.asarray, seeded_variables(shapes, np.random.default_rng(seed)))


def assert_state_equals(model, variables):
    want = flax_to_state_dict(variables, model)
    got = model.state_dict()
    for key, value in want.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], value.to(got[key].dtype)), key


@pytest.fixture(scope="module")
def yolo_streams():
    """Per version: the flax model, its seeded tree and the stream JAX wrote."""
    out = {}
    for seed, version in enumerate(("v3", "v4")):
        flax_model = FLAX[version](classes_num=2)
        variables = seeded_tree(flax_model, 64, seed)
        buf = io.BytesIO()
        jax_darknet.save_darknet_weights(variables["params"], variables["batch_stats"], buf,
                                         model=flax_model, input_size=64)
        out[version] = (flax_model, variables, buf.getvalue())
    return out


@pytest.mark.parametrize("version", ["v3", "v4"])
def test_jax_stream_loads_to_the_bridged_jax_load(yolo_streams, version):
    flax_model, variables, data = yolo_streams[version]
    net = PORT[version](2)
    assert load_darknet_weights(net, io.BytesIO(data), input_size=64) is net
    assert_state_equals(net, variables)
    mine = io.BytesIO()
    save_darknet_weights(net, mine, input_size=64)
    assert mine.getvalue() == data
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats = jax_darknet.load_darknet_weights(
        zeros["params"], zeros["batch_stats"], io.BytesIO(mine.getvalue()), model=flax_model,
        input_size=64)
    assert_state_equals(net, {"params": params, "batch_stats": stats})


@pytest.mark.parametrize("version", ["v3", "v4"])
def test_short_and_long_streams_raise(yolo_streams, version):
    _, _, data = yolo_streams[version]
    with pytest.raises(ValueError, match=r"exhausted at conv \d+/\d+ \(\S+Conv_0"):
        load_darknet_weights(PORT[version](2), io.BytesIO(data[:len(data) // 2]), input_size=64)
    with pytest.raises(ValueError, match="16 unread bytes"):
        load_darknet_weights(PORT[version](2), io.BytesIO(data + b"\x00" * 16), input_size=64)


class ManyConvs(torch.nn.Module):
    """13 ConvBNs and a DarknetConv, registered last first, called in order."""

    def __init__(self, channels=4):
        super().__init__()
        self.DarknetConv_0 = DarknetConv(4, 2, 1)
        for i in reversed(range(13)):
            self.add_module(f"ConvBN_{i}", ConvBN(channels if i == 0 else 4, 4, 1))

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(13):
            x = getattr(self, f"ConvBN_{i}")(x)
        return self.DarknetConv_0(x).permute(0, 2, 3, 1)


def test_many_siblings_walk_in_call_order():
    order = conv_call_order(ManyConvs(3), 8)
    conv_parents = [name.split(".")[0] for kind, name in order if kind == "conv"]
    assert conv_parents == [f"ConvBN_{i}" for i in range(13)] + ["DarknetConv_0"]
    assert [k for k, _ in order] == ["conv", "bn"] * 13 + ["conv"]
    assert [name for _, name in order][:2] == ["ConvBN_0.DarknetConv_0.Conv_0",
                                               "ConvBN_0.BatchNorm_0"]


@pytest.mark.parametrize("header", ["<3iq", "<4i"])
def test_stream_assignment_by_call_order(header):
    """The i-th conv of the stream is the constant i (a sorted walk would give
    ConvBN_2 the values of ConvBN_10); version 0.2 and 0.1 headers."""
    net = ManyConvs()
    buf = io.BytesIO()
    buf.write(struct.pack(header, 0, 2 if header == "<3iq" else 1, 0, 0))
    for i in range(13):
        buf.write(np.full(4 * 4, float(i), np.float32).tobytes())       # beta/gamma/mean/var
        buf.write(np.full(4 * 4, float(i), np.float32).tobytes())       # 4x4x1x1 kernel
    buf.write(np.full(2, 13.0, np.float32).tobytes())                   # DarknetConv bias
    buf.write(np.full(8, 13.0, np.float32).tobytes())
    buf.seek(0)
    load_darknet_weights(net, buf, input_size=8, channels=4)
    for i in range(13):
        assert (getattr(net, f"ConvBN_{i}").DarknetConv_0.Conv_0.weight == i).all()
        assert (getattr(net, f"ConvBN_{i}").BatchNorm_0.running_var == i).all()
    assert (net.DarknetConv_0.Conv_0.bias == 13).all()


# the cfg of tests/test_convert_and_utils.py (TINY_CFG)
TINY_CFG = """
[net]
height=32
width=32
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=mish

[convolutional]
batch_normalize=1
filters=16
size=3
stride=1
pad=1
activation=leaky

[shortcut]
from=-2
activation=linear

[convolutional]
filters=12
size=1
stride=1
pad=1
activation=linear

[yolo]

[route]
layers=-3

[maxpool]
size=2
stride=2

[convolutional]
batch_normalize=1
filters=8
size=1
stride=1
pad=1
activation=leaky

[upsample]
stride=2

[route]
layers=-1,1

[convolutional]
filters=12
size=1
stride=1
pad=1
activation=linear

[yolo]
"""


def test_cfg_parse_build_forward_and_weights_match_jax(tmp_path):
    assert parse_darknet_cfg(TINY_CFG) == jax_cfg.parse_darknet_cfg(TINY_CFG)
    flax_model, (h, w) = jax_cfg.build_from_cfg(TINY_CFG)
    variables = seeded_tree(flax_model, h, 7)
    net, size = build_from_cfg(TINY_CFG, device="cpu")
    assert size == (h, w) == (32, 32)
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    x = np.random.default_rng(1).uniform(0, 1, (2, h, w, 3)).astype(np.float32)
    want = flax_model.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net.eval()(torch.from_numpy(x))
    assert len(got) == len(want) == 2
    for g, wv in zip(got, want):
        wv = np.asarray(wv)
        assert g.shape == wv.shape == (2, 16, 16, 12)
        np.testing.assert_allclose(g.numpy(), wv, rtol=1e-5, atol=1e-5 * np.abs(wv).max())

    wfile = str(tmp_path / "tiny.weights")
    jax_darknet.save_darknet_weights(variables["params"], variables["batch_stats"], wfile,
                                     model=flax_model, input_size=(h, w))
    _, jax_loaded = jax_cfg.load_cfg_weights(TINY_CFG, wfile)
    loaded = load_cfg_weights(TINY_CFG, wfile, device="cpu")
    assert_state_equals(loaded, jax.tree.map(np.asarray, jax_loaded))
    with pytest.raises(ValueError, match=r"exhausted at conv \d+/\d+"):
        load_cfg_weights(TINY_CFG.replace("filters=8", "filters=24"), wfile, device="cpu")


def test_cfg_unsupported_section_raises():
    net, _ = build_from_cfg("[net]\nheight=8\nwidth=8\n[connected]\noutput=10\n", device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        net(torch.zeros(1, 8, 8, 3))


@pytest.fixture(scope="module")
def v3_h5(tmp_path_factory, yolo_streams):
    flax_model, variables, _ = yolo_streams["v3"]
    root = tmp_path_factory.mktemp("h5")
    path = str(root / "v3.h5")
    jax_h5.save_keras_h5_weights(variables["params"], variables["batch_stats"], path,
                                 model=flax_model, input_size=64)
    yield flax_model, variables, path
    shutil.rmtree(root, ignore_errors=True)     # ~250 MB


def test_h5_round_trip_matches_jax(v3_h5, disposable_tmp):
    tmp_path = disposable_tmp
    flax_model, variables, path = v3_h5
    net = YoloV3(2)
    assert load_keras_h5_weights(net, path, input_size=64) == []
    assert_state_equals(net, variables)
    mine = str(tmp_path / "port.h5")
    save_keras_h5_weights(net, mine, input_size=64)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats, skipped = jax_h5.load_keras_h5_weights(
        zeros["params"], zeros["batch_stats"], mine, model=flax_model, input_size=64)
    assert skipped == []
    assert_state_equals(net, {"params": params, "batch_stats": stats})


def test_h5_strict_and_skip_match_jax(v3_h5):
    _, variables, path = v3_h5
    with pytest.raises(ValueError, match="shape mismatch"):
        load_keras_h5_weights(YoloV3(5), path, input_size=64)
    net = YoloV3(5)
    skipped = load_keras_h5_weights(net, path, input_size=64, strict=False)
    flax5 = FlaxYoloV3(classes_num=5)
    shapes = jax.eval_shape(flax5.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    params, stats, want = jax_h5.load_keras_h5_weights(
        zeros["params"], zeros["batch_stats"], path, model=flax5, input_size=64, strict=False)
    assert len(skipped) == len(want) == 6
    for (i, key, got_shape, model_shape), (j, path_, h5_shape, flax_shape) in zip(skipped, want):
        assert (i, got_shape, model_shape) == (j, h5_shape, flax_shape)
        assert key == ".".join(path_[:-1]) + (".weight" if path_[-1] == "kernel" else ".bias")
        assert "DarknetConv" in key
    loaded = net.state_dict()
    for key, value in flax_to_state_dict({"params": params, "batch_stats": stats}).items():
        if "DarknetConv_" not in key.split(".")[0] and "num_batches" not in key:
            assert torch.equal(loaded[key], value), key


class OneConvBN(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.ConvBN_0 = ConvBN(4, 4, 1)

    def forward(self, x):
        return self.ConvBN_0(x.permute(0, 3, 1, 2))


def test_h5_unconsumed_layers_raise(tmp_path):
    path = str(tmp_path / "many.h5")
    save_keras_h5_weights(ManyConvs(), path, input_size=8, channels=4)
    with pytest.raises(ValueError, match="unconsumed"):
        load_keras_h5_weights(OneConvBN(), path, input_size=8, channels=4)


@pytest.mark.parametrize("suffix", [".weights", ".h5"])
def test_convert_cli_writes_a_directory_the_server_serves(disposable_tmp, suffix):
    tmp_path = disposable_tmp
    source = YoloV3(3)
    init_weights(source, 4)
    weights = str(tmp_path / f"v3{suffix}")
    save = save_darknet_weights if suffix == ".weights" else save_keras_h5_weights
    save(source, weights, input_size=64)
    out = tmp_path / "converted"
    convert_darknet.main(["--weights", weights, "--version", "v3", "--classesNum", "3",
                          "--imageSize", "64", "--out", str(out), "--device", "cpu"])
    assert sorted(p.name for p in out.iterdir()) == ["0.pt"]
    app, service, model = serve.build_app(serve.parse_args(
        ["--version", "v3", "--modelPath", str(out), "--imageSize", "64", "--device", "cpu"]
        + write_yolo_inputs(tmp_path)))
    want = source.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in model.state_dict().items()
               if "num_batches" not in k)
    status, answer = answer_one_request(app)
    assert status.startswith("200") and set(answer) >= {"boxes", "classes"}
    assert service.request_count == 1

"""``tools/export_torch_weights.py``: a saved JAX YOLOv4 checkpoint becomes the
``.pt`` the port serves.

A full-width ``YoloV4(classes_num=2)`` state with seeded weights is saved through
``tmv_tpu.core.checkpoint.CheckpointManager``, exported, loaded into the port
and served by ``tmv_tpu_torch.cli.serve --modelPath``. The exported tensors must
equal the checkpoint's, transposed where the layouts differ.
"""

import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tmv_tpu.core.checkpoint import CheckpointManager
from tmv_tpu.core.train_state import TrainState
from tmv_tpu.models.yolo_v4 import YoloV4 as FlaxYoloV4
from tmv_tpu_torch.cli import serve
from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS
from torch_port_cases import seeded_variables

TOOL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "tools", "export_torch_weights.py")


def load_tool():
    spec = importlib.util.spec_from_file_location("export_torch_weights", TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_checkpoint_round_trips_into_the_port(tmp_path, rng):
    shapes = jax.eval_shape(FlaxYoloV4(classes_num=2).init, jax.random.key(0),
                            jnp.zeros((1, 64, 64, 3)))
    variables = seeded_variables(shapes, rng)
    state = TrainState.create(variables["params"], variables["batch_stats"], optax.sgd(1e-3))
    state = state.replace(step=jnp.asarray(7, jnp.int32))
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(7, state)
    mgr.close()

    classes_file = tmp_path / "classes.txt"
    classes_file.write_text("cat\ndog\n")
    out = tmp_path / "yolov4.pt"
    load_tool().main(["--modelPath", str(tmp_path / "ckpt"), "--classesFile",
                      str(classes_file), "--out", str(out)])

    exported = torch.load(out, weights_only=True)
    params, stats = variables["params"], variables["batch_stats"]
    np.testing.assert_array_equal(
        exported["BlocksLayer2_1.ConvBN_7.DarknetConv_0.Conv_0.weight"].numpy(),
        np.asarray(params["BlocksLayer2_1"]["ConvBN_7"]["DarknetConv_0"]["Conv_0"]["kernel"])
        .transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(exported["DarknetConv_2.Conv_0.bias"].numpy(),
                                  np.asarray(params["DarknetConv_2"]["Conv_0"]["bias"]))
    np.testing.assert_array_equal(
        exported["LastLayer_0.ConvBN_4.BatchNorm_0.running_var"].numpy(),
        np.asarray(stats["LastLayer_0"]["ConvBN_4"]["BatchNorm_0"]["var"]))

    anchors_file = tmp_path / "anchors.txt"
    anchors_file.write_text(",".join(str(int(v)) for v in COCO_ANCHORS[::-1].reshape(-1)))
    args = serve.parse_args(["--modelPath", str(out), "--classesFile", str(classes_file),
                             "--anchorsFile", str(anchors_file), "--imageSize", "64",
                             "--device", "cpu"])
    _, model = serve.build_service(args)
    served = model.state_dict()
    assert all(torch.equal(served[k], v) for k, v in exported.items())


def _jax_checkpoint(path, flax_model, x0, rng, step=3):
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), x0)
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    state = TrainState.create(variables["params"], variables["batch_stats"], optax.adam(1e-3))
    mgr = CheckpointManager(str(path))
    mgr.save(step, state.replace(step=jnp.asarray(step, jnp.int32)))
    mgr.close()
    return variables


def test_efficientdet_and_v3_resnet_checkpoints_export_and_serve(tmp_path, rng):
    """``--family efficientdet`` (D0 at 64 px, 2 classes + background, an Adam
    checkpoint: ``restore_weights`` ignores the optimizer) and ``--version
    v3``/``resnet``: every exported tensor equals the bridged checkpoint, and
    ``cli/serve.py --modelPath`` loads the ``.pt`` strictly."""
    from tmv_tpu.models.efficientdet import EfficientDetNet
    from tmv_tpu.models.moco import ResNetYoloV3 as FlaxResNetYoloV3
    from tmv_tpu.models.yolo_v3 import YoloV3 as FlaxYoloV3
    from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
    from tmv_tpu_torch.models.efficientdet.harness import efficientdet_config

    classes_file = tmp_path / "classes.txt"
    classes_file.write_text("cat\ndog\n")
    anchors_file = tmp_path / "anchors.txt"
    anchors_file.write_text(",".join(str(int(v)) for v in COCO_ANCHORS[::-1].reshape(-1)))
    x0 = jnp.zeros((1, 64, 64, 3))
    cases = {
        "efficientdet": (EfficientDetNet(config=efficientdet_config("efficientdet-d0", 3, 64)),
                         ["--family", "efficientdet", "--modelName", "efficientdet-d0",
                          "--imageSize", "64"],
                         ["--family", "efficientdet", "--imageSize", "64"]),
        "v3": (FlaxYoloV3(classes_num=2), ["--version", "v3"],
               ["--version", "v3", "--anchorsFile", str(anchors_file), "--imageSize", "64"]),
        "resnet": (FlaxResNetYoloV3(out_filters=21), ["--version", "resnet"],
                   ["--version", "resnet", "--anchorsFile", str(anchors_file),
                    "--imageSize", "64"]),
    }
    for name, (flax_model, export_args, serve_args) in cases.items():
        variables = _jax_checkpoint(tmp_path / f"ckpt_{name}", flax_model, x0, rng)
        out = tmp_path / f"{name}.pt"
        load_tool().main(["--modelPath", str(tmp_path / f"ckpt_{name}"), "--classesFile",
                          str(classes_file), "--out", str(out)] + export_args)
        exported = torch.load(out, weights_only=True)
        for key, value in flax_to_state_dict(variables).items():
            assert torch.equal(exported[key], value), (name, key)
        _, model = serve.build_service(serve.parse_args(
            ["--modelPath", str(out), "--classesFile", str(classes_file), "--device", "cpu"]
            + serve_args))
        served = model.state_dict()
        assert all(torch.equal(served[k], v) for k, v in exported.items()), name
        shutil.rmtree(tmp_path / f"ckpt_{name}")     # ~250 MB each for the YOLOs
        out.unlink()

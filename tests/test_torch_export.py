"""``tools/export_torch_weights.py``: a saved JAX YOLOv4 checkpoint becomes the
``.pt`` the port serves.

A full-width ``YoloV4(classes_num=2)`` state with seeded weights is saved through
``tmv_tpu.core.checkpoint.CheckpointManager``, exported, loaded into the port
and served by ``tmv_tpu_torch.cli.serve --modelPath``. The exported tensors must
equal the checkpoint's, transposed where the layouts differ.
"""

import importlib.util
import os

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

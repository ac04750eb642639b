"""The port's YOLOv4 predict path and its serving, against the JAX package.

- ``make_yolo_predict`` and ``make_yolo_predict_batched`` against JAX's
  ``make_yolo_predict`` at 64×64, ``iou_type="diou"``, f32, on the same bridged
  seeded weights. The output convs' box channels are scaled by 1e-4 so that the
  boxes are finite and valid while the class and objectness logits stay
  saturated: scores tie at exactly 1.0, the case the stable sorts exist for.
  Valid masks and ids must be exactly equal; boxes and scores agree to
  rtol 1e-5 / atol 1e-5.
- The port's serve path (``tmv_tpu_torch.cli.serve.build_app``), driven
  in-process with a WSGI ``environ`` on ``--device cpu``.
- Neither ``import tmv_tpu_torch`` nor building its servers (both families; YOLO
  v4, v3 and resnet), nor the converters, nor
  the trainer's and eval CLI's arguments, pipeline and train state, pulls in
  ``tmv_tpu``, jax or flax; the model factories default to the card.
"""

import base64
import io
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tmv_tpu.models.detector_harness import make_yolo_predict as jax_make_yolo_predict
from tmv_tpu.models.yolo_v4 import YoloV4 as FlaxYoloV4
from tmv_tpu_torch.cli import serve
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict
from tmv_tpu_torch.models.detector_harness import make_yolo_predict, make_yolo_predict_batched
from tmv_tpu_torch.models.yolo_v4 import COCO_ANCHORS, YoloV4
from torch_port_cases import seeded_variables, write_labelme

SIZE = (64, 64)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(3)
    flax_model = FlaxYoloV4(classes_num=2)
    shapes = jax.eval_shape(flax_model.init, jax.random.key(0), jnp.zeros((1, 64, 64, 3)))
    variables = jax.tree.map(np.asarray, seeded_variables(shapes, rng))
    for name in ("DarknetConv_0", "DarknetConv_1", "DarknetConv_2"):
        kernel = variables["params"][name]["Conv_0"]["kernel"]
        kernel[..., np.arange(kernel.shape[-1]) % 7 < 4] *= 1e-4
    net = YoloV4(classes_num=2)
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    images = rng.uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    jax_predict = jax_make_yolo_predict(flax_model, SIZE, COCO_ANCHORS, 2, iou_type="diou",
                                        nms_backend="xla")
    want = [[np.asarray(o) for o in jax_predict(variables, jnp.asarray(images[i:i + 1]))]
            for i in range(len(images))]
    return net.eval(), images, want


def assert_same_detections(got, want):
    g_boxes, g_ids, g_scores, g_valid = got
    w_boxes, w_ids, w_scores, w_valid = want
    assert g_boxes.shape == w_boxes.shape == (500, 4)
    np.testing.assert_array_equal(g_valid, w_valid)
    assert w_valid.sum() > 5
    np.testing.assert_array_equal(g_ids[g_valid], w_ids[w_valid])
    np.testing.assert_allclose(g_boxes[g_valid], w_boxes[w_valid], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g_scores[g_valid], w_scores[w_valid], rtol=1e-5, atol=1e-5)


def test_predict_matches_jax(models):
    net, images, want = models
    predict = make_yolo_predict(net, SIZE, COCO_ANCHORS, 2, iou_type="diou")
    for i in range(len(images)):
        got = predict(None, images[i:i + 1])
        assert all(isinstance(g, np.ndarray) for g in got)
        assert_same_detections(got, want[i])


def test_batched_predict_matches_jax(models):
    net, images, want = models
    got = make_yolo_predict_batched(net, SIZE, COCO_ANCHORS, 2, iou_type="diou")(None, images)
    assert got[0].shape == (3, 500, 4) and got[3].shape == (3, 500)
    for i in range(len(images)):
        assert_same_detections([g[i] for g in got], want[i])


def _write_inputs(tmp_path, classes=3):
    classes_file = tmp_path / "classes.txt"
    classes_file.write_text("\n".join(f"class_{i}" for i in range(classes)) + "\n")
    anchors_file = tmp_path / "anchors.txt"
    anchors_file.write_text(",".join(str(int(v)) for v in COCO_ANCHORS[::-1].reshape(-1)))
    return ["--classesFile", str(classes_file), "--anchorsFile", str(anchors_file)]


def _post(app, payload):
    body = json.dumps(payload).encode()
    status = {}

    def start_response(s, headers):
        status["status"] = s

    environ = {"PATH_INFO": "/ai_api/object_detection/predict", "REQUEST_METHOD": "POST",
               "CONTENT_LENGTH": str(len(body)), "wsgi.input": io.BytesIO(body)}
    out = b"".join(app(environ, start_response))
    return status["status"], json.loads(out)


def _data_url(rng, h, w):
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "JPEG")
    return "data:image/jpeg;base64," + base64.b64encode(buf.getvalue()).decode()


@pytest.mark.parametrize("batch", [1, 2])
def test_serve_path_answers_the_reference_contract(tmp_path, rng, batch):
    args = serve.parse_args(_write_inputs(tmp_path) + [
        "--randomInit", "--seed", "0", "--imageSize", "64", "--device", "cpu",
        "--batch", str(batch)])
    app, service, model = serve.build_app(args)
    assert next(model.parameters()).device.type == "cpu"
    try:
        for read in (1, 0):
            status, out = _post(app, {"img_data": _data_url(rng, 48, 80), "read": read})
            assert status.startswith("200"), out
            assert set(out) == {"boxes", "classes", "random_img", "result_img"}
            assert len(out["boxes"]) == len(out["classes"])
            assert bool(out["result_img"]) == bool(read)
        assert service.request_count == 2
    finally:
        if service.batcher is not None:
            service.batcher.close()


def test_serve_refuses_unported_flags_and_missing_weights(tmp_path, capsys):
    base = _write_inputs(tmp_path)
    # --spatial is ported, with the JAX server's rules
    assert serve.parse_args(base + ["--randomInit", "--spatial", "2"]).spatial == 2
    for extra, why in ((["--batch", "2"], "--spatial is the latency direction: --batch 1"),
                       (["--dp", "2", "--batch", "2"], "no --dp"),
                       (["--imageSize", "66", "--spatial", "4"], "--imageSize 66 is not "
                        "divisible by --spatial 4")):
        with pytest.raises(SystemExit):
            serve.parse_args(base + ["--randomInit", "--spatial", "2"] + extra)
        assert why in capsys.readouterr().err
    # --dp is ported, with the JAX server's rules
    with pytest.raises(SystemExit):
        serve.parse_args(base + ["--randomInit", "--dp", "2"])
    assert "--dp requires --batch > 1" in capsys.readouterr().err
    assert serve.parse_args(base + ["--randomInit", "--dp", "2", "--batch", "16"]).dp == 2
    # the int8 flags follow the JAX server's rules
    for extra, why in ((["--int8", "--int8Static", "calib"], "mutually exclusive"),
                       (["--int8", "--batch", "2"], "only supported with --batch 1")):
        with pytest.raises(SystemExit):
            serve.parse_args(base + ["--randomInit"] + extra)
        assert why in capsys.readouterr().err
    assert serve.quant_of(serve.parse_args(base + ["--randomInit", "--int8"])) == "int8"
    args = serve.parse_args(base + ["--randomInit", "--int8Static", "calib", "--batch", "16"])
    assert serve.quant_of(args) == "int8_static" and args.int8Margin == 1.0
    assert "per-TENSOR scales loses" in capsys.readouterr().out
    serve.parse_args(base + ["--randomInit", "--int8Static", "calib", "--int8PerChannel"])
    assert "WARNING" not in capsys.readouterr().out
    for version in ("v3", "resnet"):
        assert serve.parse_args(base + ["--randomInit", "--version", version]).version == version
    with pytest.raises(SystemExit):
        serve.parse_args(base)                   # neither --modelPath nor --randomInit
    with pytest.raises(SystemExit):
        serve.parse_args(base[:2] + ["--randomInit"])   # yolo without --anchorsFile


@pytest.mark.parametrize("family", ["v4", "v3", "resnet", "efficientdet"])
def test_seeded_init_sets_every_weight_of_an_uninitialized_build(family):
    """The servers and the eval CLI build their models without weight values
    (``uninitialized=True``) and then load or seed them: the seeded init must set every
    parameter and buffer (NaN and -7 planted in each are all gone)."""
    from tmv_tpu_torch.models.detector_harness import build_yolo_model
    from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet
    from tmv_tpu_torch.models.efficientdet.net import init_weights as d0_init
    from tmv_tpu_torch.models.layers.common import init_weights

    if family == "efficientdet":
        model, _ = build_efficientdet("efficientdet-d0", 4, 64, device="cpu", uninitialized=True)
        init = d0_init
    else:
        model, _ = build_yolo_model(family, 3, device="cpu", uninitialized=True)
        init = init_weights
    tensors = dict(model.named_parameters()) | dict(model.named_buffers())
    with torch.no_grad():
        for t in tensors.values():
            t.fill_(float("nan") if t.is_floating_point() else -7)
    init(model, 0)
    left = [name for name, t in tensors.items()
            if (t.isnan() if t.is_floating_point() else t == -7).any()]
    assert not left, left


def test_device_cuda_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = serve.parse_args(_write_inputs(tmp_path) + ["--randomInit", "--imageSize", "64"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_service(args)


def test_port_imports_no_jax(tmp_path):
    """Every module of the package (``quant/*`` and ``kernels/int8_conv.py`` among
    them), a whole server build of each family (YOLO v4 in float and in
    ``--int8Static --int8PerChannel``, v3 and resnet, EfficientDet), the converters' call-order trace, a cfg net,
    ``freeze_mask``, and the trainers', converter's and eval CLI's arguments,
    pipelines (EfficientDet's host and device augmentation), train states and
    D0's loss at a tiny size, the WSGI module built from the environment, the
    detect CLI's and UNet trainer's arguments, the UNet dataset, the mosaic and
    cached YOLO pipelines, a remat step, and FaceNet's three CLIs' arguments, an
    IRv1 with remat, its padded embeddings, the mining, the optax-rule optimizers
    and the LFW evaluation, the MoCo and distillation CLIs' arguments, a MoCo
    train state (query and key towers, queue) and the pseudo-labeler, the
    visualize package, the export CLI's and ``serve --artifact``'s arguments,
    ``serving/export.py``, the space-to-depth stem conv and every module of
    ``tmv_tpu_torch.parallel`` with ``torch.distributed`` leave ``tmv_tpu`` (and jax,
    flax, jaxlib, optax, sklearn and matplotlib) out of ``sys.modules``; h5py may be
    loaded."""
    yolo = _write_inputs(tmp_path) + ["--randomInit", "--imageSize", "32", "--device", "cpu",
                                      "--batch", "2"]
    det = _write_inputs(tmp_path)[:2] + ["--family", "efficientdet", "--randomInit",
                                         "--imageSize", "64", "--device", "cpu"]
    Image.fromarray(np.zeros((40, 48, 3), np.uint8)).save(tmp_path / "im0.png")
    (tmp_path / "labels.txt").write_text("im0.png|class_1,2,3,20,30|\n")
    files = _write_inputs(tmp_path)
    train = files + ["--trainData", str(tmp_path / "labels.txt"), "--trainImagePath",
                     str(tmp_path), "--imageSize", "32", "--batchSize", "2", "--device", "cpu"]
    evaluate = files + ["--imagePath", str(tmp_path), "--labelFile",
                        str(tmp_path / "labels.txt"), "--imageSize", "32", "--device", "cpu"]
    train_d0 = files[:2] + ["--trainData", str(tmp_path / "labels.txt"), "--trainImagePath",
                            str(tmp_path), "--modelName", "efficientdet-d0", "--imageSize",
                            "64", "--batchSize", "2", "--deviceAug", "--device", "cpu"]
    evaluate_d0 = files[:2] + ["--family", "efficientdet", "--imagePath", str(tmp_path),
                               "--labelFile", str(tmp_path / "labels.txt"), "--imageSize", "64",
                               "--device", "cpu"]
    write_labelme(tmp_path)
    unet_args = ["--labelPath", str(tmp_path), "--inputSize", "32", "--depth", "2",
                 "--filtersBase", "4", "--batchSize", "2", "--remat", "--device", "cpu"]
    wsgi_env = {"TMV_CLASSES_FILE": files[1], "TMV_FAMILY": "efficientdet",
                "TMV_MODEL_PATH": str(tmp_path / "d0.pt"), "TMV_IMAGE_SIZE": "64",
                "TMV_BF16": "0", "TMV_DEVICE": "cpu"}
    detect_args = ["--image", str(tmp_path / "im0.png"), "--modelPath", "m"] + files
    code = ("import sys, pkgutil, importlib, tmv_tpu_torch\n"
            "for m in pkgutil.walk_packages(tmv_tpu_torch.__path__, 'tmv_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import torch.distributed, torch.distributed.fsdp, torch.distributed.tensor\n"
            "for name in ('collectives', 'fsdp', 'inference', 'launch', 'mesh', 'train'):\n"
            "    importlib.import_module('tmv_tpu_torch.parallel.' + name)\n"
            "from tmv_tpu_torch.parallel import DataParallel, FullyShardedDataParallel\n"
            "import torch\n"
            "torch.set_num_threads(1)   # no OpenMP spinning under parallel test workers\n"
            "from tmv_tpu_torch.cli import eval_map, serve, train_yolo\n"
            "from tmv_tpu_torch.core.train_state import TrainState, make_train_step\n"
            "from tmv_tpu_torch.data.loaders import load_anchors\n"
            "from tmv_tpu_torch.data.yolo_pipeline import YoloDataPipeline\n"
            "from tmv_tpu_torch.models.detector_harness import build_yolo_model\n"
            f"_, service, _ = serve.build_app(serve.parse_args({yolo!r}))\n"
            "service.batcher.close()\n"
            f"_, service, model = serve.build_app(serve.parse_args({yolo!r} + ['--int8Static', {str(tmp_path)!r}, '--int8PerChannel']))\n"
            "service.batcher.close()\n"
            "assert model.ConvBN_0.kernel_q.dtype == torch.int8\n"
            "for version in ('v3', 'resnet'):\n"
            f"    _, service, _ = serve.build_app(serve.parse_args({yolo!r} + ['--version', version]))\n"
            "    service.batcher.close()\n"
            "from tmv_tpu_torch.cli import convert_darknet\n"
            "from tmv_tpu_torch.convert.darknet import conv_call_order\n"
            "from tmv_tpu_torch.convert.darknet_cfg import build_from_cfg\n"
            "from tmv_tpu_torch.models.detector_harness import freeze_mask\n"
            "convert_darknet.parse_args(['--weights', 'w.weights', '--out', 'o'])\n"
            "m, _ = build_yolo_model('v3', 2, device='cpu')\n"
            "assert len(conv_call_order(m, 64)) == 147 and sum(freeze_mask(m, ['DarknetConv_0']).values()) == 2\n"
            "build_from_cfg('[net]\\nheight=32\\nwidth=32\\n[convolutional]\\nfilters=4\\n', device='cpu')\n"
            f"serve.build_app(serve.parse_args({det!r}))\n"
            f"a = train_yolo.parse_args({train!r})\n"
            f"e = eval_map.parse_args({evaluate!r})\n"
            "anchors = load_anchors(a.anchorsFile)\n"
            "p = YoloDataPipeline(a.trainImagePath, a.trainData, a.classesFile, a.batchSize,\n"
            "                     anchors, image_wh=(32, 32), prefetch=0, device=a.device)\n"
            "batch = next(iter(p))\n"
            "model, _ = build_yolo_model('v4', p.classes_num, device='cpu')\n"
            "state = TrainState.create(model, torch.optim.Adam(model.parameters()))\n"
            "assert batch['image'].shape == (2, 32, 32, 3) and state.step == 0\n"
            "from tmv_tpu_torch.cli import train_efficientdet\n"
            "from tmv_tpu_torch.core.train_state import make_line_search_train_step\n"
            "from tmv_tpu_torch.data.efficientdet_pipeline import EfficientDetPipeline\n"
            "from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet\n"
            "from tmv_tpu_torch.models.efficientdet.net import make_efficientdet_loss_fn\n"
            f"d = train_efficientdet.parse_args({train_d0!r})\n"
            f"eval_map.parse_args({evaluate_d0!r})\n"
            "net, anchors = build_efficientdet('efficientdet-d0', 4, 64, device='cpu')\n"
            "for aug in (False, True):\n"
            "    b = next(iter(EfficientDetPipeline(d.trainImagePath, d.trainData,\n"
            "        d.classesFile, 2, anchors, 4, image_size=64, device_aug=aug, prefetch=0,\n"
            "        device=d.device)))\n"
            "gen = torch.Generator().manual_seed(0)\n"
            "loss, _ = make_efficientdet_loss_fn(generator=gen)(net.train(), b)\n"
            "make_line_search_train_step(make_efficientdet_loss_fn(generator=gen))\n"
            "assert b['image'].shape == (2, 64, 64, 3) and bool(torch.isfinite(loss))\n"
            "import os\n"
            "torch.save(net.state_dict(), " + repr(wsgi_env["TMV_MODEL_PATH"]) + ")\n"
            f"os.environ.update({wsgi_env!r})\n"
            "import tmv_tpu_torch.serving.wsgi as wsgi\n"
            "wsgi = importlib.reload(wsgi)\n"
            "assert callable(wsgi.application)\n"
            "from tmv_tpu_torch.cli import detect, train_unet\n"
            f"detect.parse_args({detect_args!r})\n"
            f"u = train_unet.parse_args({unet_args!r})\n"
            "from tmv_tpu_torch.data.unet_dataset import get_dataset\n"
            "from tmv_tpu_torch.models.unet import UNetLogits, make_unet_loss_fn\n"
            "batches, _ = get_dataset(u.labelPath, 2, 4, (32, 32), (32, 32))\n"
            "ub = next(batches)\n"
            "unet = UNetLogits(depth=u.depth, filters_base=u.filtersBase, remat=u.remat,\n"
            "                  output_filters=4)\n"
            "ustate = TrainState.create(unet, torch.optim.Adam(unet.parameters()))\n"
            "m = make_train_step(make_unet_loss_fn(), clip_global_norm=10.0)(ustate, ub)\n"
            "assert ustate.step == 1 and bool(torch.isfinite(m['loss']))\n"
            "p = YoloDataPipeline(a.trainImagePath, a.trainData, a.classesFile, a.batchSize,\n"
            "                     load_anchors(a.anchorsFile), image_wh=(32, 32), prefetch=0,\n"
            "                     mosaic=1.0,\n"
            "                     cache_dir=" + repr(str(tmp_path / "cache")) + ", device='cpu')\n"
            "assert next(iter(p))['image'].shape == (2, 32, 32, 3)\n"
            "assert p.cache.filled_count == 1\n"
            "import numpy as np\n"
            "from tmv_tpu_torch.cli import facenet_distance, train_facenet, validate_on_lfw\n"
            "from tmv_tpu_torch.models.facenet import FaceNetModel, get_embeddings, lfw\n"
            "from tmv_tpu_torch.models.facenet import select_triplets\n"
            "f = train_facenet.parse_args(['--filesPath', 'f', '--remat', '--device', 'cpu'])\n"
            "validate_on_lfw.parse_args(['--lfwDir', 'd', '--lfwPairs', 'p', '--modelPath', 'm'])\n"
            "facenet_distance.parse_args(['a.jpg', '--modelPath', 'm'])\n"
            "net = FaceNetModel(8, remat=f.remat, device=f.device)\n"
            "assert get_embeddings(net, np.zeros((3, 80, 80, 3), np.float32), 2).shape == (3, 8)\n"
            "t, v = select_triplets(torch.randn(3, 4, 8), torch.ones(3, 4, dtype=torch.bool), 0.2,\n"
            "                       generator=torch.Generator().manual_seed(0))\n"
            "assert t.shape == (144, 3) and v.shape == (144,)\n"
            "train_facenet.make_optimizer('RMSPROP', 1e-3, net.parameters())\n"
            "train_facenet.make_optimizer('ADAGRAD', 1e-3, net.parameters())\n"
            "lfw.evaluate(np.random.default_rng(0).normal(size=(40, 8)), [True, False] * 10)\n"
            "from tmv_tpu_torch.cli import train_distill, train_moco\n"
            "from tmv_tpu_torch.models.distill import make_pseudo_label_fn\n"
            "mo = train_moco.parse_args(['--imageSize', '32', '--queueSize', '4',\n"
            "                            '--outFilters', '18', '--device', 'cpu'])\n"
            "ms, dim = train_moco.moco_train_state(mo, torch.device(mo.device))\n"
            "assert dim == 21 * 18 and ms.extra.queue.shape == (4, dim)\n"
            "di = train_distill.parse_args(['--mode', 'dump_labels', '--device', 'cpu'])\n"
            "out = make_pseudo_label_fn(ms.model, load_anchors(a.anchorsFile), (32, 32), 1)(\n"
            "    torch.zeros(1, 32, 32, 3), conf=torch.full((1,), 0.4))\n"
            "assert out[0].shape == (1, 100, 4)\n"
            "import tmv_tpu_torch.visualize\n"
            "from tmv_tpu_torch.cli import export_model\n"
            "from tmv_tpu_torch.ops.space_to_depth import s2d_stem_conv\n"
            "from tmv_tpu_torch.serving.export import load_program\n"
            "export_model.parse_args(['--classesFile', 'c.txt', '--anchorsFile', 'a.txt',\n"
            "                         '--out', 'o.tmvt', '--int8Static', 'calib'])\n"
            "serve.parse_args(['--classesFile', 'c.txt', '--artifact', 'o.tmvt'])\n"
            "assert s2d_stem_conv(torch.zeros(1, 3, 8, 8), torch.zeros(4, 3, 3, 3)).shape == (1, 4, 4, 4)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('tmv_tpu', 'jax', 'flax', 'jaxlib', 'optax', 'sklearn', 'matplotlib'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_model_factories_default_to_the_card():
    """``build_yolo_model`` and ``build_efficientdet`` build on the card unless
    asked for the CPU; without a card that default raises."""
    from tmv_tpu_torch.models.detector_harness import build_yolo_model
    from tmv_tpu_torch.models.efficientdet.harness import build_efficientdet

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_yolo_model("v4", 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_efficientdet("efficientdet-d0", 4, 64)
    model, _ = build_yolo_model("v4", 3, device="cpu")
    assert next(model.parameters()).device.type == "cpu"

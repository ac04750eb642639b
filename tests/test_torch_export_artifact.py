"""The port's serving artifacts (``serving/export.py``, ``cli/export_model.py``,
``serve --artifact``), mirroring ``tests/test_export.py`` at 64 px with 3 classes.

- YOLOv3 and EfficientDet-D0 on the same seeded flax weights (bridged): the port's
  artifact, baked and unbaked, reproduces the live predictor on the CPU, drives
  ``DetectionService``, and agrees with JAX's own artifact of the same weights
  (``tmv_tpu.serving.export``, ``platforms=("cpu",)``, the weights an argument):
  valid counts equal, ids equal,
  boxes and scores within 1e-4·max|JAX| (f32).
- The refusals: another magic, a JAX ``.tmvx``, a device outside ``platforms``, a
  mismatched ``--imageSize``.
- ``cli/export_model.py --version v3`` on a ``.pt`` of those weights and ``serve
  --artifact`` end to end; the export CLI's ``--int8Static --int8PerChannel`` YOLOv4
  predictor against its artifact; every exported graph holds the ``tmv::`` custom op
  of each kernel its live path launches, and no plain version is traced into it (the
  plain versions raise while the program is traced).
- The reverse bridge: flax → state_dict → flax is the identity for YOLOv3 and D0.
"""

import io
import json
import tarfile
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from tmv_tpu.models.efficientdet import EfficientDetNet as FlaxEfficientDetNet
from tmv_tpu.models.efficientdet.harness import (
    make_efficientdet_predict as jax_make_efficientdet_predict,
)
from tmv_tpu.models.detector_harness import make_yolo_predict as jax_make_yolo_predict
from tmv_tpu.models.yolo_v3 import YoloV3 as FlaxYoloV3
from tmv_tpu.ops.anchors import Anchors as JaxAnchors
from tmv_tpu.serving import export as jax_export
from tmv_tpu_torch.cli import export_model, serve
from tmv_tpu_torch.convert.flax_bridge import flax_to_state_dict, state_dict_to_flax
from tmv_tpu_torch.kernels import dwconv, int8_conv, nms_sweep
from tmv_tpu_torch.models.detector_harness import build_yolo_model, make_yolo_predict_batched
from tmv_tpu_torch.models.efficientdet.harness import (
    build_efficientdet, efficientdet_config, make_efficientdet_predict_batched,
)
from tmv_tpu_torch.serving.app import DetectionService
from tmv_tpu_torch.serving.export import (
    export_predictor, load_predictor, read_export_meta,
)
from torch_port_cases import answer_one_request

SIZE = 64
# the COCO anchors scaled to the 64 px input (coarsest scale first), as integers: the
# anchors file that the CLIs read holds integers
ANCHORS = np.maximum(np.round(np.array(
    [[[116, 90], [156, 198], [373, 326]], [[30, 61], [62, 45], [59, 119]],
     [[10, 13], [16, 30], [33, 23]]]) * SIZE / 416), 1).astype(np.int64)


def write_inputs(root):
    """A classes file and the anchors file of ``ANCHORS`` → the CLIs' arguments."""
    (root / "classes.txt").write_text("a\nb\nc\n")
    (root / "anchors.txt").write_text(",".join(str(v) for v in ANCHORS[::-1].reshape(-1)))
    return ["--classesFile", str(root / "classes.txt"), "--anchorsFile",
            str(root / "anchors.txt")]
# the export CLI's thresholds below; its predictors keep 500 outputs
YOLO_KW = dict(confidence_thresh=0.5, scores_thresh=0.5, iou_thresh=0.5)
D0_KW = dict(score_threshold=0.0, max_output_size=50)


def assert_predictions_equal(ref, out, rtol=1e-6, atol=1e-6):
    """(boxes, ids, scores, valid) compared on the valid rows only (the padded slots
    hold whatever the masking left), as ``tests/test_export.py``."""
    rb, ri, rs, rv = (np.asarray(t) for t in ref)
    ob, oi, os_, ov = (np.asarray(t) for t in out)
    np.testing.assert_array_equal(rv, ov)
    v = rv.reshape(-1)
    np.testing.assert_allclose(rb.reshape(-1, 4)[v], ob.reshape(-1, 4)[v], rtol=rtol, atol=atol)
    np.testing.assert_array_equal(ri.reshape(-1)[v], oi.reshape(-1)[v])
    np.testing.assert_allclose(rs.reshape(-1)[v], os_.reshape(-1)[v], rtol=rtol, atol=atol)


def assert_matches_jax(got, want):
    """The port's artifact against JAX's: valid counts equal, and each JAX detection
    matched one to one by a port detection of the same class with its box and score
    within 1e-4·max|JAX|. Matched, not row by row: scores that saturate to 1 in one
    package may round an ulp below it in the other, which reorders near-tied rows."""
    g_boxes, g_ids, g_scores, g_valid = (np.asarray(t).reshape(np.asarray(w).shape)
                                         for t, w in zip(got, want))
    w_boxes, w_ids, w_scores, w_valid = (np.asarray(t) for t in want)
    assert w_valid.sum() > 0
    assert g_valid.sum() == w_valid.sum()
    box_tol = 1e-4 * np.abs(w_boxes[w_valid]).max()
    score_tol = 1e-4 * np.abs(w_scores[w_valid]).max()
    free = list(zip(g_boxes[g_valid], g_ids[g_valid], g_scores[g_valid]))
    for box, cls, score in zip(w_boxes[w_valid], w_ids[w_valid], w_scores[w_valid]):
        match = next((i for i, (b, c, sc) in enumerate(free)
                      if c == cls and np.abs(b - box).max() <= box_tol
                      and abs(sc - score) <= score_tol), None)
        assert match is not None, f"no port detection for JAX's {cls} {box} {score}"
        free.pop(match)


def graph_ops(program):
    return [str(n.target) for n in program.graph.nodes if n.op == "call_function"]


def no_plain_versions():
    """Patches that make every kernel's plain version raise: a program traced under
    them holds none of them."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version was traced into the artifact")

    return [mock.patch.object(nms_sweep, "greedy_sweep_reference", refuse),
            mock.patch.object(dwconv, "dw_bn_swish_reference", refuse),
            mock.patch.object(int8_conv, "int8_conv_reference", refuse),
            mock.patch.object(int8_conv, "int8_dwconv_reference", refuse)]


def traced_without_plain_versions(fn):
    patches = no_plain_versions()
    for p in patches:
        p.start()
    try:
        return fn()
    finally:
        for p in patches:
            p.stop()


def seeded_flax_tree(net, rng, kernel_scale=1.0):
    """A flax tree for ``net`` made with ``state_dict_to_flax`` from seeded values, as
    ``seeded_variables`` fills a flax ``eval_shape`` tree: He-uniform kernels (times
    ``kernel_scale``), non-trivial BatchNorm scale, bias, mean and variance."""
    fill = {"running_var": lambda s: rng.uniform(0.5, 1.5, s),
            "running_mean": lambda s: rng.normal(0, 0.1, s)}
    state = {}
    for key, t in net.state_dict().items():
        leaf = key.rsplit(".", 1)[1]
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            value = np.zeros(shape)
        elif leaf.startswith("WSM_"):          # a BiFPN fusion weight: He-uniform, fan-in 1
            value = rng.uniform(-np.sqrt(6.0), np.sqrt(6.0), shape)
        elif leaf in fill:
            value = fill[leaf](shape)
        elif t.dim() < 2 and leaf == "weight":
            value = rng.uniform(0.8, 1.2, shape)
        elif t.dim() < 2:
            value = rng.normal(0, 0.05, shape)
        else:
            limit = np.sqrt(6.0 / (np.prod(shape[1:]) if t.dim() == 4 else shape[1]))
            value = rng.uniform(-limit, limit, shape) * kernel_scale
        state[key] = torch.from_numpy(np.asarray(value, np.float32))
    return state_dict_to_flax(state)


@pytest.fixture(scope="module")
def image():
    return np.random.default_rng(0).uniform(size=(1, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def yolo(tmp_path_factory, image):
    """YOLOv3 on seeded flax weights (kernels scaled by 0.2, as ``tests/test_export.py``
    scales them), the bridged port model and its live predictor; ``cli/export_model.py
    --version v3`` on a ``.pt`` of those weights (traced with every plain version refusing) served by
    ``serve --artifact`` on the CPU; an unbaked export of the live predictor, loaded;
    and JAX's artifact of the flax weights, with its output on ``image``."""
    root = tmp_path_factory.mktemp("export_yolo")
    inputs = write_inputs(root)
    flax_model = FlaxYoloV3(classes_num=3)
    net, iou_type = build_yolo_model("v3", 3, device="cpu")
    variables = seeded_flax_tree(net, np.random.default_rng(1), kernel_scale=0.2)
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    net = net.to(memory_format=torch.channels_last).eval()
    predict = make_yolo_predict_batched(net, (SIZE, SIZE), ANCHORS, 3, iou_type=iou_type,
                                        **YOLO_KW)
    torch.save(net.state_dict(), root / "v3.pt")
    path = str(root / "v3.tmvt")
    meta = traced_without_plain_versions(lambda: export_model.main(
        inputs + ["--version", "v3", "--modelPath", str(root / "v3.pt"), "--imageSize",
                  str(SIZE), "--device", "cpu", "--out", path, "--confidenceThresh", "0.5",
                  "--scoresThresh", "0.5", "--iouThresh", "0.5"]))
    (root / "v3.pt").unlink()
    app, service, model = serve.build_app(serve.parse_args(
        inputs[:2] + ["--artifact", path, "--imageSize", str(SIZE), "--device", "cpu"]))
    assert model is None
    unbaked = export_predictor(predict, None, image)
    jax_predict = jax_make_yolo_predict(flax_model, (SIZE, SIZE), ANCHORS, 3,
                                        iou_type=iou_type, nms_backend="xla", **YOLO_KW)
    jax_blob = jax_export.export_predictor(jax_predict, variables, image, platforms=("cpu",))
    return dict(variables=variables, net=net, predict=predict, path=path, meta=meta,
                inputs=inputs, app=app, service=service, unbaked=unbaked,
                unbaked_loaded=load_predictor(unbaked, device="cpu"), jax_blob=jax_blob,
                jax_out=jax_export.load_predictor(jax_blob)(variables, image))


@pytest.fixture(scope="module")
def d0(image):
    """EfficientDet-D0 (3 classes + background) on seeded flax weights: the live
    predictor, its baked artifact (traced with every plain version refusing), loaded,
    and JAX's artifact's output."""
    cfg = efficientdet_config("efficientdet-d0", 4, SIZE)
    flax_model = FlaxEfficientDetNet(config=cfg)
    net, anchors = build_efficientdet("efficientdet-d0", 4, SIZE, device="cpu")
    variables = seeded_flax_tree(net, np.random.default_rng(2))
    net.load_state_dict(flax_to_state_dict(variables, net), strict=True)
    net = net.to(memory_format=torch.channels_last).eval()
    predict = make_efficientdet_predict_batched(net, anchors, SIZE, **D0_KW)
    jax_anchors = JaxAnchors(cfg.min_level, cfg.max_level, (SIZE, SIZE), cfg.num_scales,
                             cfg.aspect_ratios, cfg.anchor_scale)
    jax_predict = jax_make_efficientdet_predict(flax_model, jax_anchors, SIZE,
                                                nms_backend="xla", **D0_KW)
    jax_blob = jax_export.export_predictor(jax_predict, variables, image, platforms=("cpu",))
    blob = traced_without_plain_versions(
        lambda: export_predictor(predict, None, image, bake_variables=True,
                                 meta={"image_size": SIZE, "family": "efficientdet"}))
    return dict(variables=variables, net=net, predict=predict,
                loaded=load_predictor(blob, device="cpu"),
                jax_out=jax_export.load_predictor(jax_blob)(variables, image))


@pytest.fixture(scope="module")
def int8(tmp_path_factory):
    """The export CLI's ``--int8Static --int8PerChannel`` predictor on the seeded
    YOLOv4 (3 classes @64, float32, on the CPU; 4 calibration JPEGs) and its baked
    artifact, traced with every plain version refusing, loaded."""
    root = tmp_path_factory.mktemp("export_int8")
    inputs = write_inputs(root)
    calib = root / "calib"
    calib.mkdir()
    rng = np.random.default_rng(3)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (48, 80, 3), dtype=np.uint8)).save(
            calib / f"im{i}.jpg")
    args = export_model.parse_args(inputs + [
        "--imageSize", str(SIZE), "--device", "cpu", "--int8Static", str(calib),
        "--int8PerChannel", "--out", str(root / "v4_int8.tmvt")])
    live, quant = export_model.live_predictor(args)
    meta = {"image_size": SIZE, "version": "v4", "quant": quant}
    blob = traced_without_plain_versions(lambda: export_predictor(
        live, None, np.zeros((1, SIZE, SIZE, 3), np.float32), bake_variables=True, meta=meta))
    return dict(meta=read_export_meta(blob), live=live, loaded=load_predictor(blob, device="cpu"))


@pytest.mark.parametrize("kind", ["baked", "unbaked"])
def test_round_trip(yolo, image, kind):
    if kind == "baked":
        loaded, variables = yolo["service"].predict_fn, None
    else:
        loaded, variables = yolo["unbaked_loaded"], yolo["net"].state_dict()
    assert loaded.baked == (kind == "baked")
    ref = yolo["predict"](None, image)
    assert ref[3].sum() > 0
    assert_predictions_equal(ref, loaded(variables, image))


def test_unbaked_holds_no_weights_and_takes_them(yolo, image):
    net, loaded = yolo["net"], yolo["unbaked_loaded"]
    weight_bytes = sum(t.numel() * t.element_size() for t in net.state_dict().values())
    assert len(yolo["unbaked"]) < weight_bytes / 20
    with pytest.raises(ValueError, match="state_dict"):
        loaded(None, image)
    # other weights (halved: exact in both directions) give the live model's answer
    halve = {k: v * 0.5 if v.is_floating_point() else v for k, v in net.state_dict().items()}
    net.load_state_dict(halve)
    try:
        want = yolo["predict"](None, image)
    finally:
        net.load_state_dict({k: v * 2 if v.is_floating_point() else v for k, v in halve.items()})
    assert_predictions_equal(want, loaded(halve, image))


def test_baked_artifact_drives_detection_service(yolo):
    live = DetectionService(lambda v, im: tuple(o[0] for o in yolo["predict"](v, im)), None,
                            ["a", "b", "c"], image_wh=(SIZE, SIZE))
    raw = np.random.default_rng(1).integers(0, 255, (48, 96, 3)).astype(np.uint8)
    b1, i1, s1, _ = live.predict_image(raw)
    b2, i2, s2, _ = yolo["service"].predict_image(raw)
    assert len(b1) > 0
    np.testing.assert_array_equal(b1, b2)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(s1, s2, rtol=1e-6)


def _tar(members):
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def test_both_platforms_on_the_cpu(yolo, tmp_path):
    """The default ``platforms`` (cuda, cpu) artifact, traced on the CPU, runs there
    (``test_round_trip``); a device outside an artifact's ``platforms`` is refused, and
    so are platforms the port has no program for."""
    assert yolo["meta"]["platforms"] == ["cuda", "cpu"]
    with tarfile.open(yolo["path"]) as tar:
        members = {m.name: tar.extractfile(m).read() for m in tar.getmembers()}
    members["META"] = json.dumps(dict(yolo["meta"], platforms=["cuda"])).encode()
    cuda_only = tmp_path / "cuda_only.tmvt"
    cuda_only.write_bytes(_tar(members))
    with pytest.raises(ValueError, match="exported for"):
        load_predictor(str(cuda_only), device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        export_predictor(yolo["predict"], None, np.zeros((1, SIZE, SIZE, 3), np.float32),
                         platforms=("tpu", "cpu"))


@pytest.mark.parametrize("which", ["bad magic", "JAX tmvx"])
def test_refuses_what_is_not_a_port_artifact(yolo, tmp_path, which):
    path = tmp_path / "a.tmvx"
    path.write_bytes(_tar({"MAGIC": b"something-else"}) if which == "bad magic"
                     else yolo["jax_blob"])
    match = "magic" if which == "bad magic" else "JAX artifact"
    with pytest.raises(ValueError, match=match):
        load_predictor(str(path), device="cpu")


def test_meta_round_trip(yolo, image):
    """META: the export CLI's keys (JAX's, and the family), the input's shape and
    dtype, the platforms; an unbaked artifact also names the ``state_dict`` it takes."""
    meta = read_export_meta(yolo["path"])
    assert meta == yolo["meta"] == {
        "image_size": SIZE, "version": "v3", "classes_num": 3, "quant": "off",
        "family": "yolo", "input_shape": list(image.shape), "input_dtype": "float32",
        "platforms": ["cuda", "cpu"]}
    assert read_export_meta(yolo["unbaked"])["variables"] == list(yolo["net"].state_dict())


@pytest.mark.parametrize("model", ["yolov3", "d0"])
def test_artifact_matches_jax_artifact(yolo, d0, image, model):
    case, loaded = ((yolo, yolo["service"].predict_fn) if model == "yolov3"
                    else (d0, d0["loaded"]))
    assert_matches_jax(loaded(None, image), case["jax_out"])


def test_efficientdet_artifact_matches_live_and_serves(d0, image):
    ref = d0["predict"](None, image)
    assert ref[3].sum() > 0
    assert_predictions_equal(ref, d0["loaded"](None, image), rtol=1e-5, atol=1e-5)
    service = DetectionService(d0["loaded"], None, ["a", "b", "c"], (SIZE, SIZE))
    boxes, ids, scores = service.predict_prepared(image[0], (SIZE, SIZE), (0, 0, 0, 0))
    assert boxes.ndim == 2 and boxes.shape[1] == 4 and len(boxes) == len(ids) == len(scores)


@pytest.mark.parametrize("which, ops", [
    ("yolov3", {"tmv.nms_sweep.default": 1}),
    ("yolov4 int8", {"tmv.nms_sweep.default": 1, "tmv.int8_conv.default": 107}),
    ("d0", {"tmv.nms_sweep.default": 1, "tmv.dw_bn_swish.default": 16}),
])
def test_graph_holds_the_kernels_ops(yolo, int8, d0, which, ops):
    """Each program holds one ``tmv::`` node per launch of its live path (the int8
    YOLOv4: 107 ``int8_conv``, one per ConvBN) and no plain version: each was traced
    with the plain versions raising."""
    loaded = {"yolov3": yolo["service"].predict_fn, "yolov4 int8": int8["loaded"],
              "d0": d0["loaded"]}[which]
    found = graph_ops(loaded.program)
    assert loaded.baked
    assert {op: found.count(op) for op in ops} == ops
    assert not {op for op in found if op.startswith("tmv.")} - set(ops)


def test_int8_artifact_equals_the_live_int8_predictor(int8):
    """The export CLI's ``--int8Static --int8PerChannel`` predictor
    (``export_model.live_predictor``: calibrated by ``calibrate_directory``) against
    its artifact: the same detections on a served request."""
    assert int8["meta"]["quant"] == "int8_static" and int8["meta"]["version"] == "v4"
    live = DetectionService(lambda v, im: tuple(o[0] for o in int8["live"](v, im)), None,
                            ["a", "b", "c"], (SIZE, SIZE))
    aot = DetectionService(int8["loaded"], None, ["a", "b", "c"], (SIZE, SIZE))
    raw = np.random.default_rng(4).integers(0, 255, (48, 96, 3)).astype(np.uint8)
    b1, i1, s1, _ = live.predict_image(raw)
    b2, i2, s2, _ = aot.predict_image(raw)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(b1, b2, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(s1, s2, rtol=1e-5, atol=1e-5)


def test_serve_artifact_answers_the_reference_contract(yolo):
    status, out = answer_one_request(yolo["app"])
    assert status.startswith("200")
    assert set(out) == {"boxes", "classes", "random_img", "result_img"}
    assert yolo["service"].variables is None and yolo["service"].request_count >= 1


def test_serve_artifact_refuses_a_mismatched_image_size(yolo, capsys):
    args = serve.parse_args(yolo["inputs"][:2] + ["--artifact", yolo["path"], "--imageSize",
                                                  "416", "--device", "cpu"])
    with pytest.raises(SystemExit, match="does not match the artifact"):
        serve.build_service(args)
    for extra in (["--batch", "2"], ["--bf16"], ["--randomInit"], ["--int8"]):
        with pytest.raises(SystemExit):
            serve.parse_args(yolo["inputs"][:2] + ["--artifact", "a.tmvt"] + extra)
        assert "cannot be combined with --artifact" in capsys.readouterr().err


def test_export_cli_rules(capsys):
    with pytest.raises(SystemExit):
        export_model.parse_args(["--classesFile", "c.txt", "--out", "o.tmvt"])
    assert "--anchorsFile is required" in capsys.readouterr().err
    args = export_model.parse_args(["--classesFile", "c.txt", "--out", "o.tmvt", "--family",
                                    "efficientdet"])
    assert (args.device, args.platforms, args.int8Margin) == ("cuda", "cuda,cpu", 1.0)


@pytest.mark.parametrize("model", ["yolov3", "d0"])
def test_flax_round_trip_through_the_state_dict(yolo, d0, model):
    """flax → ``flax_to_state_dict`` → ``state_dict_to_flax`` is the identity, leaf by
    leaf (the way a port checkpoint goes back to the JAX package), on the trees the JAX
    artifacts ran on (their JAX models take them, so they have flax's structure)."""
    case = yolo if model == "yolov3" else d0
    back = state_dict_to_flax(case["net"].state_dict())
    want = jax.tree_util.tree_flatten_with_path(case["variables"])[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32, path
        np.testing.assert_array_equal(g, w)

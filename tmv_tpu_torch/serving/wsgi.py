"""WSGI entry module for uWSGI / gunicorn deploys of the port.

Port of ``tmv_tpu/serving/wsgi.py`` (the reference's `ai_server/wsgi.py` and
`uwsgi.ini`): each worker process builds the warm predictor once, at import,
from environment variables:

    TMV_MODEL_PATH     checkpoint dir or .pt  (default ./data/yolo_weights)
    TMV_CLASSES_FILE   classes txt            (required)
    TMV_FAMILY         yolo | efficientdet    (default yolo)
    TMV_ANCHORS_FILE   anchors csv            (required for yolo)
    TMV_VERSION        v3 | v4 | resnet       (default v4; yolo family)
    TMV_MODEL_NAME     efficientdet config    (default efficientdet-d0)
    TMV_IMAGE_SIZE     letterbox size         (default 416)
    TMV_BF16           1 = bfloat16 compute   (default 1)
    TMV_DEVICE         cuda | cpu             (default cuda; raises without a card)

The application is ``cli/serve.py::build_app`` on those settings: the same
model factories, the weights loaded by ``core/checkpoint.py::load_weights`` (a port
checkpoint directory's latest step or a ``.pt``), one image per call. Point
gunicorn at ``tmv_tpu_torch.serving.wsgi:application`` or uWSGI at ``module =
tmv_tpu_torch.serving.wsgi:application``. Without ``TMV_CLASSES_FILE`` the
module defines no application, so importing it for documentation is harmless.
"""

import argparse
import os


def settings() -> argparse.Namespace:
    """The ``cli/serve.py`` arguments of the environment's deployment."""
    env = os.environ.get
    return argparse.Namespace(
        modelPath=env("TMV_MODEL_PATH", "./data/yolo_weights"), randomInit=False, seed=0,
        classesFile=os.environ["TMV_CLASSES_FILE"], anchorsFile=env("TMV_ANCHORS_FILE"),
        imageSize=int(env("TMV_IMAGE_SIZE", "416")), device=env("TMV_DEVICE", "cuda"),
        bf16=env("TMV_BF16", "1") == "1", batch=1, batchWaitMs=4.0,
        version=env("TMV_VERSION", "v4"), family=env("TMV_FAMILY", "yolo"),
        modelName=env("TMV_MODEL_NAME", "efficientdet-d0"))


def build_application():
    """The WSGI callable of the environment's deployment."""
    from tmv_tpu_torch.cli.serve import build_app

    args = settings()
    if args.family == "yolo" and args.anchorsFile is None:
        raise KeyError("TMV_ANCHORS_FILE is required for TMV_FAMILY=yolo")
    app, _, _ = build_app(args)
    return app


# uWSGI/gunicorn import this module per worker; skip when imported for docs
if os.environ.get("TMV_CLASSES_FILE"):
    application = build_application()

"""HTTP serving layer: the reference's detection endpoint, GPU-backed.

The port's own copy of ``tmv_tpu/serving/app.py`` with the same HTTP contract:
``POST /ai_api/object_detection/predict`` takes ``{"img_data": "<base64
data-url>", "read": 1}`` and answers ``{"boxes", "classes", "random_img",
"result_img"}``; ``/healthz``, ``/ai_api/object_detection/stats`` and the index
view as there. A dependency-free WSGI app (wsgiref, uWSGI or gunicorn) around a
warm predictor that returns host numpy arrays.

JPEG decode and encode go through PIL only: the JAX package's native libjpeg
path (``native/preproc.cc``) is not ported.
"""

import json
import time
from typing import Callable

import numpy as np

from tmv_tpu_torch.utils import image_helper as ImageHelper


class DetectionService:
    """Warm predictor wrapper: image array → (boxes, class_ids, scores)."""

    def __init__(self, predict_fn: Callable, variables, classes_name,
                 image_wh=(416, 416)):
        """predict_fn: (variables, (1,H,W,3) float [0,1]) →
        (boxes_norm, classes_id, scores, valid)."""
        self.predict_fn = predict_fn
        self.variables = variables
        self.classes_name = classes_name
        self.image_wh = image_wh
        # operational counters for the /stats endpoint
        self.request_count = 0
        self.latencies_ms: list = []
        self.batcher = None  # set by cli/serve.py when micro-batching

    def predict_image(self, img_old: np.ndarray):
        image_size = np.int32(self.image_wh)
        img, _, padding = ImageHelper.proportional_resize(
            img_old, image_size, bg_color=(0, 0, 0)
        )
        width, height = ImageHelper.get_image_size(img_old)
        y_boxes, y_ids, y_scores = self.predict_prepared(
            img.astype(np.float32) / 255.0, (width, height), padding)
        return y_boxes, y_ids, y_scores, img

    def predict_prepared(self, predict_img: np.ndarray, orig_wh, padding):
        """Predict + un-letterbox on an already letterboxed [0,1] frame.
        ``padding`` is (top, bottom, left, right) in letterbox pixels."""
        image_size = np.int32(self.image_wh)
        width, height = orig_wh
        boxes, ids, scores, valid = self.predict_fn(
            self.variables, predict_img[None]
        )
        v = np.asarray(valid)
        y_boxes = np.asarray(boxes)[v]
        y_ids = np.asarray(ids)[v]
        y_scores = np.asarray(scores)[v]
        # un-letterbox: normalized boxes → original pixels
        y_boxes[:, [0, 2]] = (
            (y_boxes[:, [0, 2]] * image_size[0] - padding[2])
            / (image_size[0] - padding[2] - padding[3]) * width
        )
        y_boxes[:, [1, 3]] = (
            (y_boxes[:, [1, 3]] * image_size[1] - padding[0])
            / (image_size[1] - padding[0] - padding[1]) * height
        )
        y_boxes[:, 0] = np.clip(y_boxes[:, 0], 0, None)
        y_boxes[:, 1] = np.clip(y_boxes[:, 1], 0, None)
        y_boxes[:, 2] = np.clip(y_boxes[:, 2], None, width)
        y_boxes[:, 3] = np.clip(y_boxes[:, 3], None, height)
        mask = ((y_boxes[:, 2] - y_boxes[:, 0] > 2)
                & (y_boxes[:, 3] - y_boxes[:, 1] > 2))
        return y_boxes[mask].astype(np.int32), y_ids[mask], y_scores[mask]


def _encode_image_b64(img: np.ndarray) -> str:
    """uint8 RGB → base64 JPEG (PIL)."""
    return ImageHelper.bytes_to_base64(ImageHelper.image_to_bytes(img))


def create_app(service: DetectionService):
    """WSGI application with the reference's URL + JSON contract."""

    def index(environ, start_response):
        body = b"tmv_tpu AIServer"
        start_response("200 OK", [("Content-Type", "text/plain")])
        return [body]

    def predict(environ, start_response):
        try:
            size = int(environ.get("CONTENT_LENGTH") or 0)
            request_data = json.loads(environ["wsgi.input"].read(size))
            img_data = request_data["img_data"].split(",")[1]
            img_bytes = ImageHelper.base64_to_bytes(img_data)
            # the reference reads `read` but never uses it; here a falsy value
            # skips the two image payloads (no draw and encode on the host)
            read = request_data.get("read", 1)

            img_old = ImageHelper.bytes_to_image(img_bytes)
            y_boxes, y_ids, y_scores, letterboxed = service.predict_image(img_old)

            json_obj = {
                "boxes": y_boxes.tolist(),
                "classes": y_ids.tolist(),
                "random_img": "",
                "result_img": "",
            }
            if read:
                labels = [service.classes_name[i] for i in y_ids]
                result_img = ImageHelper.draw_boxes(
                    img_old, y_boxes, labels, y_scores)
                json_obj["random_img"] = _encode_image_b64(letterboxed)
                json_obj["result_img"] = _encode_image_b64(result_img)
            body = json.dumps(json_obj).encode()
            start_response("200 OK", [("Content-Type", "application/json")])
            return [body]
        except Exception as e:  # noqa: BLE001 — surface as 500 JSON
            body = json.dumps({"error": str(e)}).encode()
            start_response("500 Internal Server Error",
                           [("Content-Type", "application/json")])
            return [body]

    def healthz(environ, start_response):
        """Liveness/readiness: the predictor was warmed before the server
        started accepting traffic, so reachable ⇒ ready."""
        start_response("200 OK", [("Content-Type", "application/json")])
        return [json.dumps({"status": "ok"}).encode()]

    def stats(environ, start_response):
        """Operational counters: request count and latency percentiles and,
        when micro-batching, the dispatch batch-size mean."""
        out = {
            "requests": service.request_count,
            "latency_ms_p50": None,
            "latency_ms_p99": None,
        }
        lat = service.latencies_ms[-1000:]
        if lat:
            out["latency_ms_p50"] = round(float(np.percentile(lat, 50)), 3)
            out["latency_ms_p99"] = round(float(np.percentile(lat, 99)), 3)
        batcher = service.batcher
        if batcher is not None and batcher.batch_sizes:
            sizes = batcher.batch_sizes[-1000:]
            out["batch_size_mean"] = round(float(np.mean(sizes)), 2)
            out["batch_dispatches"] = batcher.dispatch_count
        start_response("200 OK", [("Content-Type", "application/json")])
        return [json.dumps(out).encode()]

    def app(environ, start_response):
        path = environ.get("PATH_INFO", "/")
        if path == "/ai_api/object_detection/predict":
            t0 = time.perf_counter()
            resp = predict(environ, start_response)
            service.request_count += 1
            service.latencies_ms.append((time.perf_counter() - t0) * 1000.0)
            if len(service.latencies_ms) > 10_000:  # bound a long server
                del service.latencies_ms[:5_000]
            return resp
        if path == "/healthz":
            return healthz(environ, start_response)
        if path == "/ai_api/object_detection/stats":
            return stats(environ, start_response)
        return index(environ, start_response)

    return app


def run_server(service: DetectionService, host: str = "0.0.0.0",
               port: int = 8000, threaded: bool = False):
    """``threaded=True`` serves each request on its own thread, which the
    micro-batching queue (``serving/batching.py``) needs to see more than one
    in-flight request."""
    import socketserver
    from wsgiref.simple_server import WSGIServer, make_server

    cls = WSGIServer
    if threaded:
        class ThreadingWSGIServer(socketserver.ThreadingMixIn, WSGIServer):
            daemon_threads = True

        cls = ThreadingWSGIServer
    srv = make_server(host, port, create_app(service), server_class=cls)
    print(f"serving on http://{host}:{port}"
          + (" (threaded)" if threaded else ""))
    srv.serve_forever()

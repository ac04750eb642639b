"""Server-side micro-batching queue for the detection endpoint.

The port's own copy of ``tmv_tpu/serving/batching.py``. Concurrent WSGI worker
threads enqueue single images; a collector thread drains the queue into a
fixed-capacity batch, runs the batched predictor once and hands each request its
own results. Batches are padded to ``max_batch`` with zeros and the padded rows'
outputs are discarded, so the predictor always sees one shape.
"""

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np


class MicroBatcher:
    """Collects concurrent single-image predicts into one device batch.

    Args:
        batched_predict: ``(variables, images (B,H,W,3) float32) →
            per-image result arrays`` (a tuple/list whose elements all have
            a leading batch axis), with ``B == max_batch`` always.
        variables: passed through to ``batched_predict``.
        max_batch: static device batch capacity.
        max_wait_ms: how long the collector waits for more requests after
            the first one before dispatching a partial batch.
    """

    def __init__(self, batched_predict: Callable, variables,
                 max_batch: int = 8, max_wait_ms: float = 4.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.batched_predict = batched_predict
        self.variables = variables
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1000.0
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self.batch_sizes: list = []  # recent dispatch sizes (bounded)
        self.dispatch_count = 0      # monotonic total
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------

    def predict_one(self, image: np.ndarray) -> Sequence[np.ndarray]:
        """Blocking single-image predict routed through the shared batch.

        ``image`` is one letterboxed (H, W, 3) float32 array; returns the
        per-image slices of the batched predictor's outputs.
        """
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        fut: Future = Future()
        self._queue.put((np.asarray(image), fut))
        return fut.result()

    def as_predict_fn(self) -> Callable:
        """Adapter with the ``DetectionService`` predictor signature
        ``(variables, (1,H,W,3)) → per-image results`` (``variables`` is
        ignored; the batcher holds its own)."""

        def predict(_variables, image):
            return self.predict_one(np.asarray(image)[0])

        return predict

    def close(self):
        self._closed = True
        self._queue.put(None)
        self._thread.join(timeout=5)

    # -- collector ----------------------------------------------------

    def _collect(self) -> Optional[list]:
        """Block for the first request, then drain up to capacity within
        the wait window.  Returns None on shutdown."""
        first = self._queue.get()
        if first is None:
            return None
        items = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(items) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # past the window: take only what is already queued
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
            else:
                try:
                    nxt = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
            if nxt is None:
                self._queue.put(None)  # propagate shutdown after this batch
                break
            items.append(nxt)
        return items

    def _worker(self):
        while True:
            items = self._collect()
            if items is None:
                return
            images = [img for img, _ in items]
            futures = [fut for _, fut in items]
            self.batch_sizes.append(len(images))
            self.dispatch_count += 1
            if len(self.batch_sizes) > 10_000:  # bound a long server
                del self.batch_sizes[:5_000]
            # A wrong-shaped image fails its own future only, never its
            # batch-mates or the collector thread.
            ref_shape = images[0].shape
            batch = np.zeros((self.max_batch,) + ref_shape, dtype=np.float32)
            live = []
            for img, fut in zip(images, futures):
                if img.shape != ref_shape:
                    fut.set_exception(ValueError(
                        f"image shape {img.shape} does not match the "
                        f"batch shape {ref_shape}"))
                    continue
                batch[len(live)] = img
                live.append(fut)
            if not live:
                continue
            try:
                outs = self.batched_predict(self.variables, batch)
                outs = [np.asarray(o) for o in outs]
                for i, fut in enumerate(live):
                    fut.set_result(tuple(o[i] for o in outs))
            except Exception as e:  # noqa: BLE001 — fail all waiters
                for fut in live:
                    if not fut.done():
                        fut.set_exception(e)

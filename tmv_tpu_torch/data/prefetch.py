"""Producer-thread prefetch of the training pipelines' batches.

The pattern of the JAX package's pipelines (``yolo_pipeline.__iter__``,
``efficientdet_pipeline._prefetched``): one daemon thread builds the next
batches (host staging, H2D and the device work it enqueues) into a bounded
queue while the caller trains. One producer keeps the draws in the order of the
synchronous path. An exception in the producer is raised in the consumer;
closing the generator stops and joins the thread.
"""

import queue
import threading
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")


def prefetch_batches(next_batch: Callable[[], T], depth: int) -> Iterator[T]:
    """``next_batch()`` forever, built ``depth`` batches ahead on a producer
    thread (``depth <= 0``: in the caller's thread)."""
    if depth <= 0:
        while True:
            yield next_batch()
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put(item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def produce():
        try:
            while not stop.is_set():
                put(next_batch())
        except BaseException as e:  # surfaced in the consumer
            put(e)

    thread = threading.Thread(target=produce, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        thread.join(timeout=60)

"""Bounded host-side prefetch and a two-stage pipeline.

The port's copy of ``prefetch_map`` and ``StagePipeline`` from
``multiviewstitch_tpu/pipeline/executor.py``. The reference runs every
stage strictly serially on one thread (AlignmentSeq,
Processor.cpp:835-1106); ``prefetch_map`` runs the producer for items
i+1..i+DEPTH on worker threads while the caller consumes item i.
Exceptions propagate at the consuming position, order is preserved, and the
pool tears down cleanly on early exit. ``pipeline/ingest.load_sequences``
uses it to decode directory i+1 while directory i moves to the device.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
R = TypeVar("R")

DEPTH = 2   # items computed ahead of the consumer (double-buffered)


def prefetch_map(fn: Callable[[T], R], items: Iterable[T]) -> Iterator[R]:
    """Yield fn(item) in order, computing up to ``DEPTH`` items ahead on
    background threads."""
    with ThreadPoolExecutor(max_workers=DEPTH) as pool:
        window: collections.deque = collections.deque()
        try:
            for x in items:
                window.append(pool.submit(fn, x))
                if len(window) > DEPTH:
                    yield window.popleft().result()
            while window:
                yield window.popleft().result()
        finally:
            for f in window:
                f.cancel()


class StagePipeline:
    """Two-stage producer / consumer pipeline: ``producer`` runs on a
    worker thread up to ``DEPTH`` items ahead, ``consumer`` on the caller's
    thread; ``run`` returns the consumer's results in order. The producer
    is typically host IO and input assembly; the consumer launches device
    work, which PyTorch queues asynchronously, so the card stays busy while
    the next item loads."""

    def __init__(self, producer: Callable, consumer: Callable):
        self.producer = producer
        self.consumer = consumer

    def run(self, items: Iterable) -> list:
        return [self.consumer(x) for x in prefetch_map(self.producer, items)]

"""Bounded host-side prefetch.

The port's copy of ``prefetch_map`` from
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

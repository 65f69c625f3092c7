"""The port's StagePipeline (pipeline/executor.py): order, the consumer on
the caller's thread, exceptions in order, overlap of producer and consumer
(tests/test_executor.py's cases)."""

import threading
import time

import pytest

from multiviewstitch_tpu_torch.pipeline.executor import (DEPTH, StagePipeline,
                                                         prefetch_map)


def test_stage_pipeline_keeps_order():
    out = StagePipeline(lambda i: i * i, lambda x: x + 1).run(range(17))
    assert out == [i * i + 1 for i in range(17)]


def test_stage_pipeline_runs_consumer_on_caller_thread():
    caller = threading.get_ident()
    producers, consumers = set(), []

    def produce(i):
        producers.add(threading.get_ident())
        return i + 1

    def consume(x):
        consumers.append(threading.get_ident())
        return x * 2

    assert StagePipeline(produce, consume).run(range(5)) == [2, 4, 6, 8, 10]
    assert consumers == [caller] * 5
    assert caller not in producers


def test_stage_pipeline_propagates_exceptions_in_order():
    seen = []

    def produce(i):
        if i == 3:
            raise ValueError("boom at 3")
        return i

    with pytest.raises(ValueError, match="boom at 3"):
        StagePipeline(produce, seen.append).run(range(6))
    assert seen == [0, 1, 2]


def test_stage_pipeline_overlaps_producer_and_consumer():
    n = 8
    t0 = time.perf_counter()
    out = StagePipeline(lambda i: (time.sleep(0.05), i)[1],
                        lambda x: (time.sleep(0.05), x)[1]).run(range(n))
    wall = time.perf_counter() - t0
    assert out == list(range(n))
    assert wall < n * 0.10 * 0.75, wall


def test_prefetch_lookahead_is_bounded():
    lock = threading.Lock()
    consumed, max_ahead = [0], [0]

    def produce(i):
        with lock:
            max_ahead[0] = max(max_ahead[0], i - consumed[0])
        time.sleep(0.01)
        return i

    for x in prefetch_map(produce, range(20)):
        with lock:
            consumed[0] = x
        time.sleep(0.01)
    assert max_ahead[0] <= DEPTH + 1, max_ahead[0]

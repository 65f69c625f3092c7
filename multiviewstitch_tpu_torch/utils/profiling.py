"""The port's tracing: program spans and counters, torch.profiler traces,
and timing of a callable.

PyTorch counterpart of ``multiviewstitch_tpu/utils/profiling.py`` (the
reference's only measurement is a clock() print around PartRecog,
Alignment.cpp:46-52; SURVEY §5.1), grown into the port's one tracing
facility:

  - ``span(name, **attrs)``: a context manager around one piece of work.
    Off (the default) it costs one flag test and returns a shared null
    context: no clock reading, no allocation, no profiler range. Inside
    ``recording()`` it records the name, the start and end
    (``time.perf_counter_ns``), the parent span and the job; while a
    torch.profiler runs it also opens ``record_function("mvs." + name)``,
    so the span lies in the profiler's trace beside the device's kernels.
  - ``count(name, n=1)``: an always-on counter of work known on the host
    (one locked dict add; never reads a device tensor). ``counters()``
    reads them; ``kernels.launch_counts()`` and
    ``io.native_loader.read_counts()`` are views of
    ``kernels.launch.<kernel>`` and ``io.native_reads.<reader>``.
  - ``recording()``: turns spans on and yields the ``Recorder``, whose
    ``jobs()`` are the spans and counter deltas of each finished ``job``
    span (``cli.main`` opens one per command). Spans stay in memory until
    the caller writes them (``write_spans``).
  - ``trace``: records the enclosed region with torch.profiler (CPU
    activity, and CUDA activity where a card is present) and writes a
    Chrome trace (``chrome://tracing``, Perfetto).
  - ``device_time``: best-of-reps wall seconds of a call, synchronising
    the card when the result lives on it.
  - ``compiled_flops``: the FLOPs of one call as PyTorch's
    ``FlopCounterMode`` counts them (matmuls, convolutions, attention).
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Callable, Dict, List, Optional

import torch

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
RANGE_PREFIX = "mvs."     # a span's profiler range is RANGE_PREFIX + name
JOB = "job"               # the span that makes a job (one per CLI command)

# -- counters ---------------------------------------------------------------

_counts: Dict[str, int] = {}
_count_lock = threading.Lock()


def count(name: str, n: int = 1):
    """Add ``n`` to the counter ``name``."""
    with _count_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters(prefix: str = "") -> Dict[str, int]:
    """The counters whose names start with ``prefix`` (a copy)."""
    with _count_lock:
        return {k: v for k, v in _counts.items() if k.startswith(prefix)}


def reset_counters(prefix: str = ""):
    """Zero the counters whose names start with ``prefix``."""
    with _count_lock:
        for k in [k for k in _counts if k.startswith(prefix)]:
            del _counts[k]


# -- spans ------------------------------------------------------------------

class SpanRecord:
    """One span: ``start_ns`` / ``end_ns`` on perf_counter_ns, ``parent``
    the id of the span it opened in on the same thread (None at the
    root), ``job`` the id of the job span it ran in (None outside one)."""
    __slots__ = ("name", "attrs", "id", "parent", "job", "start_ns",
                 "end_ns")

    def __init__(self, name, attrs, id_, parent, job):
        self.name, self.attrs, self.id = name, attrs, id_
        self.parent, self.job = parent, job
        self.start_ns = self.end_ns = 0

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class JobRecord:
    """The spans of one finished job, by start (its ``job`` span first),
    and the counters it moved (deltas)."""

    def __init__(self, spans: List[SpanRecord], counts: Dict[str, int]):
        self.spans = spans
        self.counters = counts

    def seconds(self, name: str) -> Optional[float]:
        """Summed duration of the spans called ``name`` (None: none ran)."""
        ds = [s.seconds for s in self.spans if s.name == name]
        return sum(ds) if ds else None

    def self_seconds(self, span: SpanRecord) -> float:
        """``span``'s duration less the time its children cover."""
        covered, end = 0, span.start_ns
        for a, b in sorted((c.start_ns, c.end_ns) for c in self.spans
                           if c.parent == span.id):
            a, b = max(a, end), min(b, span.end_ns)
            if b > a:
                covered += b - a
                end = b
        return (span.end_ns - span.start_ns - covered) * 1e-9

    def to_dict(self) -> dict:
        t0 = self.spans[0].start_ns if self.spans else 0
        return {"counters": dict(self.counters), "spans": [
            {"name": s.name, "id": s.id, "parent": s.parent,
             "start_s": (s.start_ns - t0) * 1e-9, "seconds": s.seconds,
             "self_seconds": self.self_seconds(s), "attrs": s.attrs}
            for s in self.spans]}


class Recorder:
    """The spans recorded while it is active (``recording()``)."""

    def __init__(self):
        self.spans: List[SpanRecord] = []     # finished, in order of ending
        self._jobs: List[JobRecord] = []
        self._ids = 0
        self._lock = threading.Lock()
        self._local = threading.local()       # each thread's open spans
        self._job = None                      # (job span, counters then)

    def jobs(self) -> List[JobRecord]:
        """The finished jobs, oldest first."""
        with self._lock:
            return list(self._jobs)

    def _open(self, name: str, attrs: dict) -> SpanRecord:
        stack = self._local.__dict__.setdefault("stack", [])
        with self._lock:
            self._ids += 1
            rec = SpanRecord(name, attrs, self._ids,
                             stack[-1].id if stack else None,
                             self._job[0].id if self._job else None)
            if name == JOB and self._job is None:
                rec.job = rec.id
                self._job = (rec, counters())
        stack.append(rec)
        rec.start_ns = time.perf_counter_ns()
        return rec

    def _close(self, rec: SpanRecord):
        rec.end_ns = time.perf_counter_ns()
        self._local.stack.pop()
        with self._lock:
            self.spans.append(rec)
            if self._job is not None and self._job[0] is rec:
                before = self._job[1]
                moved = {k: v - before.get(k, 0)
                         for k, v in counters().items()
                         if v != before.get(k, 0)}
                spans = sorted((s for s in self.spans if s.job == rec.id),
                               key=lambda s: s.start_ns)
                self._jobs.append(JobRecord(spans, moved))
                self._job = None


class _Span:
    __slots__ = ("_rec", "_name", "_attrs", "_record", "_range")

    def __init__(self, rec: Recorder, name: str, attrs: dict):
        self._rec, self._name, self._attrs = rec, name, attrs
        self._range = None

    def __enter__(self) -> SpanRecord:
        if torch.autograd.profiler._is_profiler_enabled:
            self._range = torch.autograd.profiler.record_function(
                RANGE_PREFIX + self._name)
            self._range.__enter__()
        self._record = self._rec._open(self._name, self._attrs)
        return self._record

    def __exit__(self, *exc):
        self._rec._close(self._record)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()
_recorder: Optional[Recorder] = None


def span(name: str, **attrs):
    """A context manager around one piece of work (see the module doc)."""
    rec = _recorder
    if rec is None:
        return _OFF
    return _Span(rec, name, attrs)


@contextlib.contextmanager
def recording():
    """Record spans in the enclosed region; yields the Recorder (the one
    already active, if any)."""
    global _recorder
    if _recorder is not None:
        yield _recorder
        return
    _recorder = Recorder()
    try:
        yield _recorder
    finally:
        _recorder = None


def write_spans(path: str, jobs: List[JobRecord]):
    """Write each job's spans (seconds from the job's start, self time,
    attributes) and counter deltas as JSON."""
    with open(path, "w") as f:
        json.dump({"jobs": [j.to_dict() for j in jobs]}, f, indent=1)


# -- torch.profiler and timing ----------------------------------------------

@contextlib.contextmanager
def trace(logdir: str, enabled: bool = True):
    """Record the enclosed region; on exit write ``logdir/trace.json``.
    Yields the profiler (or None when disabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _sync(out):
    """Wait for the card if any tensor in ``out`` lives on it."""
    stack = [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif hasattr(x, "__dataclass_fields__"):
            stack.extend(getattr(x, k) for k in x.__dataclass_fields__)


def device_time(fn: Callable, *args, reps: int = 5,
                warmup: int = 1) -> float:
    """Best-of-``reps`` wall seconds of fn(*args), after ``warmup`` calls;
    each timed call ends when its result is ready on the card."""
    for _ in range(warmup):
        _sync(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def compiled_flops(fn: Callable, *args) -> Optional[float]:
    """FLOPs of one call of fn(*args) by ``FlopCounterMode`` (None where
    this torch has no flop counter)."""
    try:
        from torch.utils.flop_counter import FlopCounterMode
    except ImportError:
        return None
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())

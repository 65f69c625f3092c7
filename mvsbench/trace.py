"""Reduction of one profiled job's torch.profiler trace to what the
per-layer readers and the result line's ``breakdown`` take.

The job runs inside a ``record_function(JOB)`` range and each stage
inside ``record_function(STAGE + name)``. Device events are the kernels,
copies and sets the profiler records on the card; the device-side twins
of host ranges (whose names are also host event names) are left out.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

JOB = "mvsbench.job"
STAGE = "mvsbench.stage:"
HOST_LABEL = "host"


class Span(NamedTuple):
    name: str
    start: float      # microseconds, the profiler's clock
    end: float


class TraceSummary(NamedTuple):
    window_us: float                  # the job's host span
    busy_us: float                    # union of device intervals inside it
    kernel_us: Dict[str, float]       # device time by event name
    kernel_calls: Dict[str, int]
    idle_by_stage: Dict[str, float]   # idle device time by host stage

    def kernel_time(self, pattern: str) -> Tuple[float, int]:
        """(device us, events) of the events whose name matches
        ``pattern`` (a regular expression, searched)."""
        rx = re.compile(pattern)
        us = sum(v for k, v in self.kernel_us.items() if rx.search(k))
        n = sum(v for k, v in self.kernel_calls.items() if rx.search(k))
        return us, n


def union(intervals: List[Tuple[float, float]]):
    """Sorted disjoint union of (start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def summarize(host: List[Span], device: List[Span]) -> TraceSummary:
    """``host``: the JOB range and the stage ranges; ``device``: the device
    events (clipped to the job's range)."""
    job = next(s for s in host if s.name == JOB)
    stages = [s for s in host if s.name.startswith(STAGE)]
    dev = [Span(d.name, max(d.start, job.start), min(d.end, job.end))
           for d in device if d.end > job.start and d.start < job.end]
    busy = union([(d.start, d.end) for d in dev])
    kernel_us = defaultdict(float)
    kernel_calls = defaultdict(int)
    for d in dev:
        kernel_us[d.name] += d.end - d.start
        kernel_calls[d.name] += 1
    idle = defaultdict(float)
    cuts = sorted({x for s in stages for x in (s.start, s.end)})
    prev = job.start
    for a, b in busy + [(job.end, job.end)]:
        if a > prev:        # an idle gap, cut where a stage starts or ends
            edges = [prev] + [x for x in cuts if prev < x < a] + [a]
            for x, y in zip(edges, edges[1:]):
                idle[_label(stages, x, y)] += y - x
        prev = max(prev, b)
    return TraceSummary(job.end - job.start, sum(b - a for a, b in busy),
                        dict(kernel_us), dict(kernel_calls), dict(idle))


def _label(stages: List[Span], a: float, b: float) -> str:
    """The innermost stage whose range holds the gap's midpoint."""
    mid = 0.5 * (a + b)
    inner = [s for s in stages if s.start <= mid <= s.end]
    if not inner:
        return HOST_LABEL
    return min(inner, key=lambda s: s.end - s.start).name[len(STAGE):]


def from_profile(prof) -> TraceSummary:
    """Summarize a finished ``torch.profiler.profile``."""
    import torch
    events = list(prof.events())
    cpu = torch.autograd.DeviceType.CPU
    host_names = {e.name for e in events if e.device_type == cpu}
    host = [Span(e.name, e.time_range.start, e.time_range.end)
            for e in events if e.device_type == cpu and
            (e.name == JOB or e.name.startswith(STAGE))]
    device = [Span(e.name, e.time_range.start, e.time_range.end)
              for e in events if e.device_type != cpu and
              e.name not in host_names]
    return summarize(host, device)


def breakdown(t: TraceSummary, n: int = 10):
    """The result line's ``breakdown``: the device operations with most
    time and the idle device time by what the host was doing, in s."""
    ops = sorted(t.kernel_us.items(), key=lambda kv: -kv[1])[:n]
    gaps = sorted(t.idle_by_stage.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k[:120], v / 1e6] for k, v in ops],
            "idle_gaps": [[k, v / 1e6] for k, v in gaps]}

"""The program's own spans in a cell's jobs, on the card: each stage split
into the spans inside it, the device time of the kernels launched inside
each span, and the idle card labelled by the innermost span. A tool beside
the benchmark (``run.py`` does not call it), from the root of a checkout:

    python3 mvsbench/spans.py --workload <cell> --seed <n> --jobs <k> \
        [--out <file>]

It sets up as a run of ``run.py`` does (the cell's scene from the seed,
one warm job), then runs ``k`` pairs of whole jobs with a traced run's
stage hook, the first of each pair with the program's spans off and the
second recorded (``utils.profiling.recording``), so the pairs give what
recording costs; then two jobs under torch.profiler, as a traced run
profiles its job, the first with the spans off and the second recorded.
Prints one JSON line (and writes it to ``--out``):

- ``jobs``: each job's seconds and hook-timed stage seconds; a recorded
  job also its span seconds (summed by name), the self seconds of the
  ``job`` span and of each ``stage.*`` span, and its counters;
- ``split``: per recorded job, the numbers a traced run would report as
  ``entry_s`` (the ``job`` span's self time), ``trim_s``,
  ``write_obj_s``, ``write_npts_s`` and ``poisson_weld_s``;
- ``profiled``: both profiled jobs' seconds; of the recorded one, the
  busy and window seconds, the idle device time by hook stage (as a
  traced run's ``idle_gaps``) and by the innermost program span
  (``idle_by_span``), the device seconds by the innermost span the work
  was launched in (``device_by_span``; its ``poisson.field`` is
  ``poisson_field_device_s``), and the share of each stage's idle time
  that no child span of it covers;
- ``span_off_ns``: what ``span()`` costs a call with recording off.

The reductions (``idle_by_span``, ``device_by_span``, ``job_split``) are
those a traced run's reduction would take to report the spans.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from mvsbench import harness, spec  # noqa: E402
from mvsbench import trace as tr  # noqa: E402

PREFIX = "mvs."            # the program's spans' profiler ranges


def idle_by_span(job: tr.Span, ranges: List[tr.Span],
                 device: List[tr.Span]) -> Dict[str, float]:
    """Idle device us inside ``job``, each gap cut where a program span
    starts or ends and labelled by the innermost span (``ranges``, names
    without the prefix) holding the piece, else ``tr.HOST_LABEL``: the
    gaps of ``tr.summarize``, so the total is that of its ``idle_gaps``."""
    host = [job] + [tr.Span(tr.STAGE + r.name, r.start, r.end)
                    for r in ranges]
    return tr.summarize(host, device).idle_by_stage


def device_by_span(ranges: List[tr.Span],
                   launches: List[Tuple[float, float]]) -> Dict[str, float]:
    """Device us of the work launched inside each program span: each
    (host launch time, device us) goes to the innermost span whose range
    holds the launch, else ``tr.HOST_LABEL``."""
    out: Dict[str, float] = {}
    for t, us in launches:
        inner = [r for r in ranges if r.start <= t <= r.end]
        key = (min(inner, key=lambda r: r.end - r.start).name if inner
               else tr.HOST_LABEL)
        out[key] = out.get(key, 0.0) + us
    return out


def from_profile(prof):
    """(job range, program span ranges, device events, launches) of a
    finished torch.profiler profile. A launch is a host event's start and
    the device us of the work linked to it (its kernels, copies and
    sets; the device-side twins of host ranges are left out)."""
    import torch
    events = list(prof.events())
    cpu = torch.autograd.DeviceType.CPU
    host_names = {e.name for e in events if e.device_type == cpu}
    host = [e for e in events if e.device_type == cpu]
    job = next(tr.Span(e.name, e.time_range.start, e.time_range.end)
               for e in host if e.name == tr.JOB)
    ranges = [tr.Span(e.name[len(PREFIX):], e.time_range.start,
                      e.time_range.end)
              for e in host if e.name.startswith(PREFIX)]
    device = [tr.Span(e.name, e.time_range.start, e.time_range.end)
              for e in events if e.device_type != cpu and
              e.name not in host_names]
    launches = []
    for e in host:
        us = sum(k.duration for k in e.kernels if k.name not in host_names)
        if us > 0:
            launches.append((e.time_range.start, us))
    return job, ranges, device, launches


def job_split(job) -> Dict[str, float]:
    """The host-span numbers of one recorded job (a
    ``profiling.JobRecord``), in s; a span the job did not run is left
    out."""
    root = next(s for s in job.spans if s.name == "job")
    out = {"entry_s": job.self_seconds(root)}
    for key, name in (("trim_s", "trim.largest_component"),
                      ("write_obj_s", "io.write_obj"),
                      ("write_npts_s", "io.write_npts"),
                      ("poisson_weld_s", "poisson.weld")):
        v = job.seconds(name)
        if v is not None:
            out[key] = v
    return out


def stage_self_idle(job, idle: Dict[str, float]) -> Dict[str, float]:
    """For each ``stage.*`` span of the recorded job: the share of the idle
    time inside it (labelled by it or a span below it) that is labelled by
    the stage itself, none of its children covering it."""
    parent = {s.id: s.parent for s in job.spans}
    names = {s.id: s.name for s in job.spans}
    out = {}
    for s in job.spans:
        if not s.name.startswith("stage."):
            continue
        below = {names[i] for i in names if _under(i, s.id, parent)}
        total = sum(v for k, v in idle.items() if k in below)
        if total > 0:
            out[s.name] = idle.get(s.name, 0.0) / total
    return out


def _under(i, top, parent) -> bool:
    while i is not None:
        if i == top:
            return True
        i = parent[i]
    return False


def span_off_ns(n: int = 1_000_000) -> float:
    """ns a ``with span(...)`` costs with recording off, over an empty
    loop of the same length."""
    from multiviewstitch_tpu_torch.utils.profiling import span
    t0 = time.perf_counter_ns()
    for _ in range(n):
        pass
    empty = time.perf_counter_ns() - t0
    t0 = time.perf_counter_ns()
    for _ in range(n):
        with span("x"):
            pass
    return (time.perf_counter_ns() - t0 - empty) / n


def _job_row(job, rec_job=None) -> dict:
    row = {"ok": job.ok, "seconds": job.end - job.start,
           "stages": dict(job.stages), "recording": rec_job is not None}
    if rec_job is not None:
        spans: Dict[str, float] = {}
        for s in rec_job.spans:
            spans[s.name] = spans.get(s.name, 0.0) + s.seconds
        row["spans"] = spans
        row["n_spans"] = len(rec_job.spans)
        row["self"] = {s.name: rec_job.self_seconds(s)
                       for s in rec_job.spans
                       if s.name == "job" or s.name.startswith("stage.")}
        row["counters"] = rec_job.counters
        row["split"] = job_split(rec_job)
    return row


def run(cell, seed: int, pairs: int, device) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from multiviewstitch_tpu_torch.utils import profiling
    scene = spec.scene(cell.traffic["scene"]).generate(cell.traffic, seed,
                                                       device)
    root = tempfile.mkdtemp(prefix="mvsbench-spans-")
    try:
        runner = harness.Runner(cell, scene, root, device)
        if not runner.job().ok:
            raise RuntimeError("the warm-up job failed")
        rows = []
        for _ in range(pairs):
            rows.append(_job_row(runner.job(timed_stages=True)))
            with profiling.recording() as rec:
                job = runner.job(timed_stages=True)
            rows.append(_job_row(job, rec.jobs()[-1]))
        cuda = device.type == "cuda"
        harness._sync(device)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts):
            with record_function(tr.JOB):
                off = runner.job(timed_stages=True, profile_ranges=True)
        with profiling.recording() as rec:
            with profile(activities=acts) as prof:
                with record_function(tr.JOB):
                    pjob = runner.job(timed_stages=True, profile_ranges=True)
        rec_job = rec.jobs()[-1]
        summary = tr.from_profile(prof)
        job_r, ranges, dev, launches = from_profile(prof)
        idle = idle_by_span(job_r, ranges, dev)
        by_dev = device_by_span(ranges, launches)
        s = 1e-6
        profiled = {
            "job": _job_row(pjob, rec_job), "off_job": _job_row(off),
            "busy_s": summary.busy_us * s, "window_s": summary.window_us * s,
            "idle_gaps": {k: v * s for k, v in summary.idle_by_stage.items()},
            "idle_by_span": {k: v * s for k, v in sorted(
                idle.items(), key=lambda kv: -kv[1])},
            "device_by_span": {k: v * s for k, v in sorted(
                by_dev.items(), key=lambda kv: -kv[1])},
            "poisson_field_device_s": by_dev.get("poisson.field", 0.0) * s,
            "stage_self_idle_share": stage_self_idle(rec_job, idle)}
        return {"workload": cell.name, "seed": seed,
                "device": (torch.cuda.get_device_name(0) if cuda
                           else str(device)),
                "power_limit": harness.power_limit(),
                "span_off_ns": span_off_ns(), "jobs": rows,
                "split": [r["split"] for r in rows if r["recording"]],
                "profiled": profiled}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mvsbench-spans")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--jobs", type=int, default=2,
                    help="pairs of jobs, spans off then recorded")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mvsbench-spans: no CUDA device", file=sys.stderr)
        sys.exit(2)
    cell = spec.cell(args.workload, spec.benchmark())
    line = json.dumps(run(cell, args.seed, args.jobs, torch.device("cuda")))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()

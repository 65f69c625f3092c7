"""One run of one cell: set-up, the timed window of whole jobs, the traced
job, the judging of the outputs and the result line.

A job is one user's submission: the cell's scene on disk in the
reference's layout, run through the port's entry
``multiviewstitch_tpu_torch.cli.main`` in this process, one job at a time
(a scanning station submits its next scan when the last returns), each in
a fresh work directory with ``--force``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import spec
from . import trace as tr
from .judge import Judge, verdict, worst
from .layout import write_layout

FORBIDDEN = ("jax", "jaxlib", "flax", "multiviewstitch_tpu")
JUDGED_JOBS = 4


@dataclass
class Job:
    workdir: str
    start: float = 0.0
    end: float = 0.0
    ok: bool = False
    stages: Dict[str, float] = field(default_factory=dict)


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py``)."""
    cell: spec.Cell
    scene: object
    device: object
    setup_s: float = 0.0
    jobs: List[Job] = field(default_factory=list)
    peak_bytes: int = 0
    judged: List[Dict[str, float]] = field(default_factory=list)
    trace: Optional[tr.TraceSummary] = None
    traced_job: Optional[Job] = None
    root: Optional[str] = None

    def close(self):
        """Delete the run's inputs and outputs."""
        if self.root:
            shutil.rmtree(self.root, ignore_errors=True)

    @property
    def done(self) -> List[Job]:
        return [j for j in self.jobs if j.ok]

    def stage_mean(self, name: str) -> Optional[float]:
        """Mean seconds a window job spent in stage ``name`` (traced runs
        only), or None where no job ran it."""
        vals = [j.stages[name] for j in self.done if name in j.stages]
        return sum(vals) / len(vals) if vals else None


def process_age() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def job_argv(config: dict, config_txt: str, workdir: str, device) -> list:
    cmd = config["command"]
    argv = [cmd[0], "--config", config_txt, "--workdir", workdir,
            "--device", str(device), "--force"] + list(cmd[1:])
    for k, v in config.get("set", {}).items():
        argv += ["--set", f"{k}={v}"]
    return argv


def _sync(device):
    import torch
    if getattr(device, "type", str(device)) == "cuda":
        torch.cuda.synchronize()


class Runner:
    """Runs the jobs of one cell on one scene written under ``root``."""

    def __init__(self, cell: spec.Cell, scene, root: str, device):
        from multiviewstitch_tpu_torch.cli import main
        self.cell, self.scene, self.root = cell, scene, root
        self.device = device
        self.main = main
        self.config_txt = write_layout(root, scene, cell.config["settings"])
        self.count = 0

    def render_dirs(self):
        if not self.cell.config.get("render"):
            return None
        return [os.path.join(self.root, f"seq{k}")
                for k in range(len(self.scene.sequences))]

    def job(self, timed_stages=False, profile_ranges=False) -> Job:
        """One whole job. With ``timed_stages`` each stage is timed between
        two synchronisations of the card; with ``profile_ranges`` it also
        runs inside a record_function range (a profiled job)."""
        job = Job(os.path.join(self.root, f"job{self.count}"))
        self.count += 1
        kw = {}
        if timed_stages:
            kw["stage"] = self._stage_hook(job, profile_ranges)
        argv = job_argv(self.cell.config, self.config_txt, job.workdir,
                        self.device)
        job.start = time.perf_counter()
        try:
            with contextlib.redirect_stdout(sys.stderr):
                rc = self.main(argv, **kw)
            _sync(self.device)
            job.ok = rc == 0
        except Exception:           # a failed job is counted, not fatal
            traceback.print_exc(file=sys.stderr)
            job.ok = False
        job.end = time.perf_counter()
        return job

    def _stage_hook(self, job: Job, ranges: bool):
        from torch.profiler import record_function

        def stage(name, fn):
            _sync(self.device)
            t0 = time.perf_counter()
            ctx = (record_function(tr.STAGE + name) if ranges
                   else contextlib.nullcontext())
            with ctx:
                out = fn()
                _sync(self.device)
            job.stages[name] = job.stages.get(name, 0.0) + \
                time.perf_counter() - t0
            return out
        return stage


def profiled_job(runner: Runner):
    """One job under torch.profiler; returns (job, TraceSummary)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    _sync(runner.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(tr.JOB):
            job = runner.job(timed_stages=True, profile_ranges=True)
    return job, tr.from_profile(prof)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_process_start: float) -> Run:
    """One run of ``cell``, its jobs judged. The caller reports it, then
    closes it (its files stay until then: the readers may read them)."""
    import torch
    cuda = getattr(device, "type", str(device)) == "cuda"
    scene = spec.scene(cell.traffic["scene"]).generate(cell.traffic, seed,
                                                       device)
    root = tempfile.mkdtemp(prefix="mvsbench-")
    try:
        runner = Runner(cell, scene, root, device)
        warm = runner.job()
        if not warm.ok:
            raise RuntimeError("the warm-up job failed")
        shutil.rmtree(warm.workdir, ignore_errors=True)
        run = Run(cell, scene, device, root=root)
        run.setup_s = time.perf_counter() - t_process_start
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            run.jobs.append(runner.job(timed_stages=trace))
        if cuda:
            run.peak_bytes = torch.cuda.max_memory_allocated()
        if trace:
            run.traced_job, run.trace = profiled_job(runner)
        run.judged = judge_jobs(run, runner, seed)
        return run
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise


def judge_jobs(run: Run, runner: Runner, seed: int):
    """The numbers of a sample of the window's jobs drawn from the seed,
    the last job always among them (the re-rendered rasters are the last
    job's), and of the traced job."""
    import torch
    if getattr(run.device, "type", str(run.device)) == "cuda":
        torch.cuda.empty_cache()
    judge = Judge(run.scene, run.cell.config, run.device)
    done = run.done
    picks = []
    if done:
        rng = np.random.default_rng(seed)
        k = min(JUDGED_JOBS, len(done))
        picks = sorted(set(rng.choice(len(done) - 1, size=k - 1,
                                      replace=False).tolist()
                           if k > 1 else []) | {len(done) - 1})
    jobs = [done[i] for i in picks]
    if run.traced_job is not None and run.traced_job.ok:
        jobs.append(run.traced_job)
    out = []
    for job in jobs:
        last = job is jobs[-1]
        try:
            out.append(judge.job(job.workdir, runner.render_dirs()
                                 if last else None))
        except (OSError, ValueError) as e:       # an output missing or bad
            print(f"mvsbench: judging {job.workdir}: {e}", file=sys.stderr)
            out.append(dict.fromkeys(run.cell.limits, math.inf))
    return out


def power_limit() -> Optional[str]:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else None
    except (OSError, subprocess.SubprocessError):
        return None


def _num(v):
    """A JSON-safe number: non-finite values as strings."""
    v = float(v)
    return v if math.isfinite(v) else str(v)


def report(run: Run, bench: dict, trace: bool, chips: int) -> dict:
    """The result line of a finished run."""
    import torch
    metrics = {}
    for m in spec.metrics(bench, run.cell.name, trace):
        v = spec.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    failed = sum(not j.ok for j in run.jobs) + (
        0 if run.traced_job is None or run.traced_job.ok else 1)
    numbers = worst(run.judged) if run.judged else {"jobs_judged": math.inf}
    ok, checks = verdict(numbers, run.cell.limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": int(run.peak_bytes),
              "power_limit": power_limit()}
    line = {"correct": bool(ok and failed == 0 and run.done),
            "attempted": len(run.jobs), "failed": failed,
            "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_us / 1e6
        device["window_s"] = run.trace.window_us / 1e6
        line["breakdown"] = tr.breakdown(run.trace)
    line["checks"] = {k: {"value": _num(c["value"]),
                          "limit": _num(c["limit"])}
                      for k, c in checks.items()}
    return line


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def emit(line: dict):
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for k, c in line["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(f"check correct {line['correct']} attempted {line['attempted']} "
          f"failed {line['failed']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)

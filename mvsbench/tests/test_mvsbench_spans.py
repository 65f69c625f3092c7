"""The span reductions of ``mvsbench/spans.py`` on a small recorded trace
with ``mvs.`` ranges, and on a CPU profile of recorded spans."""

import pytest
import torch

from mvsbench import spans
from mvsbench import trace as tr

K1 = "void (anonymous namespace)::consistency_kernel<true>(float const*)"
# the job of test_mvsbench_trace (stages a 0-40, b 40-100, c 60-80 in b;
# device busy 10-30 and 50-55), with program spans inside it: job 5-95,
# stage.a 5-40 holding io.write 20-35, stage.b 40-95 holding poisson.weld
# 62-75
JOB = tr.Span(tr.JOB, 0.0, 100.0)
HOST = [JOB, tr.Span(tr.STAGE + "a", 0.0, 40.0),
        tr.Span(tr.STAGE + "b", 40.0, 100.0),
        tr.Span(tr.STAGE + "c", 60.0, 80.0)]
RANGES = [tr.Span("job", 5.0, 95.0), tr.Span("stage.a", 5.0, 40.0),
          tr.Span("io.write", 20.0, 35.0), tr.Span("stage.b", 40.0, 95.0),
          tr.Span("poisson.weld", 62.0, 75.0)]
DEVICE = [tr.Span(K1, 10.0, 20.0), tr.Span(K1, 15.0, 30.0),
          tr.Span(K1, 50.0, 55.0)]


def test_idle_by_span_cuts_the_same_gaps_as_idle_gaps():
    idle = spans.idle_by_span(JOB, RANGES, DEVICE)
    # idle 0-10, 30-50, 55-100: host 0-5 and 95-100, stage.a 5-10 and
    # 35-40, io.write 30-35, stage.b 40-50, 55-62 and 75-95, weld 62-75
    assert idle == pytest.approx({
        tr.HOST_LABEL: 10.0, "stage.a": 10.0, "io.write": 5.0,
        "stage.b": 37.0, "poisson.weld": 13.0})
    gaps = tr.summarize(HOST, DEVICE).idle_by_stage
    assert sum(idle.values()) == pytest.approx(sum(gaps.values()))
    assert spans.idle_by_span(JOB, [], DEVICE) == pytest.approx(
        {tr.HOST_LABEL: sum(gaps.values())})


def test_device_by_span_goes_by_the_launch_not_the_run():
    # launched at 30 inside io.write, run later; launched at 61 in stage.b
    # before the weld opens; one launch outside every span
    launches = [(30.0, 4.0), (61.0, 2.0), (63.0, 1.5), (99.0, 0.5)]
    assert spans.device_by_span(RANGES, launches) == pytest.approx({
        "io.write": 4.0, "stage.b": 2.0, "poisson.weld": 1.5,
        tr.HOST_LABEL: 0.5})


def test_job_split_and_stage_self_idle_on_a_recorded_job():
    from multiviewstitch_tpu_torch.utils.profiling import recording, span
    with recording() as rec:
        with span("job"):
            with span("stage.trim_write"):
                with span("trim.largest_component"):
                    pass
                with span("io.write_obj"):
                    pass
            with span("stage.poisson"):
                with span("poisson.weld"):
                    pass
    (job,) = rec.jobs()
    split = spans.job_split(job)
    assert set(split) == {"entry_s", "trim_s", "write_obj_s",
                          "poisson_weld_s"}
    root = job.spans[0]
    assert split["entry_s"] == job.self_seconds(root)
    assert split["write_obj_s"] == job.seconds("io.write_obj")
    idle = {"stage.trim_write": 1.0, "io.write_obj": 8.0,
            "trim.largest_component": 1.0, "poisson.weld": 3.0,
            "stage.poisson": 1.0, tr.HOST_LABEL: 5.0, "job": 2.0}
    share = spans.stage_self_idle(job, idle)
    assert share == pytest.approx({"stage.trim_write": 0.1,
                                   "stage.poisson": 0.25})


def test_from_profile_finds_the_program_spans_of_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile, record_function
    from multiviewstitch_tpu_torch.utils.profiling import recording, span
    with recording():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function(tr.JOB):
                with span("job"):
                    with span("poisson.field"):
                        torch.ones(64).sum()
    job, ranges, device, launches = spans.from_profile(prof)
    assert job.name == tr.JOB
    assert sorted(r.name for r in ranges) == ["job", "poisson.field"]
    assert all(job.start <= r.start <= r.end <= job.end for r in ranges)
    assert device == [] and launches == []
    idle = spans.idle_by_span(job, ranges, device)
    assert sum(idle.values()) == pytest.approx(job.end - job.start)


def test_span_off_cost_is_measured():
    assert spans.span_off_ns(1000) < 1e5

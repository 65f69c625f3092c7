"""The trace reduction and every metric reader, on a small recorded trace
and a small recorded run."""


import pytest
import torch

from mvsbench import harness, spec
from mvsbench import trace as tr
from mvsbench.geometry import Cams
from mvsbench.roofline import k1, k2
from mvsbench.scenes import Frames, Scene

K1 = "void (anonymous namespace)::consistency_kernel<true>(float const*)"
K2 = "void (anonymous namespace)::oriented_points_kernel<1>(float const*)"
# a job of 100 us: stage a (0-40), stage b (40-100) with c (60-80) inside;
# device events (us) overlapping at 10-30 and 50-55
HOST = [tr.Span(tr.JOB, 0.0, 100.0), tr.Span(tr.STAGE + "a", 0.0, 40.0),
        tr.Span(tr.STAGE + "b", 40.0, 100.0),
        tr.Span(tr.STAGE + "c", 60.0, 80.0)]
DEVICE = [tr.Span(K1, 10.0, 20.0), tr.Span(K1, 15.0, 30.0),
          tr.Span(K2, 50.0, 55.0), tr.Span("Memcpy DtoH", 120.0, 130.0)]


def test_union_and_idle_by_stage():
    t = tr.summarize(HOST, DEVICE)
    assert t.window_us == 100.0 and t.busy_us == 25.0
    assert t.kernel_us == {K1: 25.0, K2: 5.0}
    # idle 0-10 and 30-40 in a, 40-50 and 55-60 in b, 60-80 in c, 80-100 b
    assert t.idle_by_stage == {"a": 20.0, "b": 35.0, "c": 20.0}
    assert t.kernel_time(k1.KERNELS) == (25.0, 2)
    assert t.kernel_time(k2.KERNELS) == (5.0, 1)
    bd = tr.breakdown(t)
    assert bd["device_ops"][0] == [K1, 25e-6]
    assert [g[0] for g in bd["idle_gaps"]] == ["b", "a", "c"] or \
        [g[0] for g in bd["idle_gaps"]] == ["b", "c", "a"]


def test_from_profile_finds_the_ranges_of_a_cpu_profile():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tr.JOB):
            with record_function(tr.STAGE + "x"):
                torch.ones(64).sum()
    t = tr.from_profile(prof)
    assert t.window_us > 0 and t.busy_us == 0.0
    assert set(t.idle_by_stage) <= {"x", tr.HOST_LABEL}


def _run(trace):
    n, h, w = 3, 8, 12
    disp = torch.full((n, h, w), 0.5)
    cams = Cams(torch.eye(3).expand(n, 3, 3), torch.eye(3).expand(n, 3, 3),
                torch.zeros(n, 3), w, h)
    scene = Scene([Frames(disp, disp, cams)], None, None, [])
    cell = spec.Cell("x", 1, {"settings": {
        "MinDsp": 0.1, "MaxDsp": 1.0, "PtSampRds": 2, "NbrFrmNum": 1,
        "NbrFrmStep": 1}}, {}, {})
    run = harness.Run(cell, scene, "cpu", setup_s=12.5, peak_bytes=3e9)
    run.jobs = [harness.Job("a", 0.0, 2.0, True, {"prep_s": 0.5}),
                harness.Job("b", 2.0, 4.0, True, {"prep_s": 0.7})]
    run.judged = [{"surface_rmse": 0.02}, {"surface_rmse": 0.04},
                  {"surface_rmse": 0.03}]
    run.trace = trace
    return run


def test_end_to_end_readers():
    run = _run(None)
    assert spec.reader("frames_per_s").read(run) == pytest.approx(3 * 2 / 4)
    assert spec.reader("setup_s").read(run) == 12.5


def test_stage_readers_are_means_and_silent_without_the_stage():
    run = _run(None)
    assert spec.reader("prep_s").read(run) == pytest.approx(0.6)
    for name in ("ingest_s", "poisson_s", "render_s", "refine_s"):
        assert spec.reader(name).read(run) is None


def test_device_readers():
    assert spec.reader("device_idle_pct").read(_run(None)) is None
    t = tr.summarize(HOST, [tr.Span(K1, 10.0, 30.0),
                            tr.Span(K2, 50.0, 55.0)])
    run = _run(t)
    assert spec.reader("device_idle_pct").read(run) == pytest.approx(75.0)
    n, h, w = 3, 8, 12
    least1 = k1.bound(torch.full((n, h, w), 0.5), 0.1, 1.0)
    assert spec.reader("k1_roofline").read(run) == pytest.approx(
        100 * least1 / 20e-6)
    least2 = k2.bound(n, h, w, 2, 1, 1)
    assert spec.reader("k2_roofline").read(run) == pytest.approx(
        100 * least2 / 5e-6)
    # launched twice for one sequence: the bound would be wrong, so silent
    t2 = tr.summarize(HOST, [tr.Span(K1, 10.0, 20.0), tr.Span(K1, 21, 30)])
    assert spec.reader("k1_roofline").read(_run(t2)) is None
    assert spec.reader("k3_roofline").read(run) is None

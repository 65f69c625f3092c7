"""The port's spans and counters (utils/profiling.py) on the CPU: off by
default and free of profiler ranges, nested under one job when recorded,
placed where ``align --demo --backend poisson`` does its work, matched by
torch.profiler's ``mvs.`` ranges, written by ``--trace DIR``, and the
Poisson weld's counters on a slab extraction."""

import json
import os
import time

import numpy as np
import pytest
import torch

from multiviewstitch_tpu_torch.utils import profiling
from multiviewstitch_tpu_torch.utils.profiling import count, recording, span

torch.set_num_threads(2)

# the spans one `align --demo --backend poisson` job runs below grid 256,
# each once
ALIGN_SPANS = {
    "job", "manifest.hash_inputs", "stage.prep", "stage.sweep_solve",
    "stage.fuse", "stage.poisson", "poisson.field", "poisson.dilate",
    "poisson.extract", "stage.trim_write", "trim.largest_component",
    "io.write_srt", "io.write_npts", "io.write_obj", "manifest.mark_done"}
ALIGN = ["align", "--demo", "--device", "cpu", "--backend", "poisson",
         "--set", "psn_dpt_max=6"]


def _mvs_ranges(events):
    return [e for e in events if e.get("name", "").startswith(
        profiling.RANGE_PREFIX) and e.get("ph") == "X"]


def test_spans_off_record_nothing_and_open_no_range():
    from torch.profiler import ProfilerActivity, profile
    assert profiling.span("a") is profiling.span("b", k=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("job"):
            with span("x"):
                torch.ones(64).sum()
    assert not [e for e in prof.events()
                if e.name.startswith(profiling.RANGE_PREFIX)]
    with recording() as rec:
        pass
    assert rec.spans == [] and rec.jobs() == []


def test_spans_nest_under_one_job_and_self_time_excludes_children():
    with recording() as rec:
        with span("outside"):
            pass
        with span("job", cmd="t"):
            with span("a"):
                time.sleep(0.01)
                with span("b"):
                    time.sleep(0.02)
                    count("t.things", 3)
                with span("b"):
                    time.sleep(0.01)
            with span("c"):
                pass
    (job,) = rec.jobs()
    by = {}
    for s in job.spans:
        by.setdefault(s.name, []).append(s)
    assert [s.name for s in job.spans][0] == "job"
    assert sorted(by) == ["a", "b", "c", "job"] and len(by["b"]) == 2
    j, a, c = by["job"][0], by["a"][0], by["c"][0]
    assert j.attrs == {"cmd": "t"} and j.parent is None
    assert {s.job for s in job.spans} == {j.id}
    assert a.parent == j.id and c.parent == j.id
    assert all(b.parent == a.id for b in by["b"])
    assert rec.spans[0].name == "outside" and rec.spans[0].job is None
    kids = sum(b.end_ns - b.start_ns for b in by["b"]) * 1e-9
    assert job.self_seconds(a) == pytest.approx(a.seconds - kids, abs=1e-9)
    assert job.self_seconds(by["b"][0]) == by["b"][0].seconds
    assert job.seconds("b") == pytest.approx(kids, abs=1e-9)
    assert job.seconds("missing") is None
    assert job.counters == {"t.things": 3}


@pytest.fixture(scope="module")
def traced_align(tmp_path_factory):
    """One traced demo job (--trace), recorded; and one without --trace."""
    from multiviewstitch_tpu_torch.cli import main
    from multiviewstitch_tpu_torch.io import native_loader
    # the writers' native library is built or loaded once a process, as a
    # warm-up job does, so the recorded job's spans do not hang on the
    # order in which tests ran before it
    assert native_loader.native_available()
    root = tmp_path_factory.mktemp("tracing")
    tdir = root / "trace"
    with recording() as rec:
        assert main(ALIGN + ["--workdir", str(root / "wd"),
                             "--trace", str(tdir)]) == 0
    cwd = os.getcwd()
    os.chdir(root)
    try:
        plain = root / "plain"
        assert main(ALIGN + ["--workdir", str(plain)]) == 0
    finally:
        os.chdir(cwd)
    return rec.jobs(), root, tdir, plain


def test_align_runs_each_span_once_where_the_work_happens(traced_align):
    (job,), root, _, _ = traced_align
    names = [s.name for s in job.spans]
    assert set(names) == ALIGN_SPANS and len(names) == len(ALIGN_SPANS)
    by = {s.name: s for s in job.spans}
    for child, parent in (("io.write_obj", "stage.trim_write"),
                          ("io.write_npts", "stage.trim_write"),
                          ("io.write_srt", "stage.trim_write"),
                          ("trim.largest_component", "stage.trim_write"),
                          ("poisson.field", "stage.poisson"),
                          ("poisson.extract", "stage.poisson"),
                          ("stage.poisson", "job"),
                          ("manifest.mark_done", "job")):
        assert by[child].parent == by[parent].id, child
    j = by["job"]
    stages = sum(s.seconds for s in job.spans if s.parent == j.id)
    assert job.self_seconds(j) == pytest.approx(j.seconds - stages,
                                                abs=1e-6)


def test_align_io_counters_match_the_written_files(traced_align):
    (job,), root, _, _ = traced_align
    res = root / "wd" / "Result"
    c = job.counters
    for f in ("Model.obj", "PSR.npts", "SRT.txt"):
        assert c["io.bytes." + f] == os.path.getsize(res / f), f
    with open(res / "Model.obj") as fh:
        lines = fh.read().splitlines()
    n_v = sum(ln.startswith("v ") for ln in lines)
    assert c["io.vertices"] == n_v == c["trim.vertices_kept"]
    assert c["io.faces"] == sum(ln.startswith("f ") for ln in lines)
    assert c["io.points"] == len(np.loadtxt(res / "PSR.npts"))
    assert c["trim.vertices_in"] == c["poisson.vertices"] >= n_v


def test_profiler_ranges_match_the_recorded_spans(traced_align):
    (job,), _, tdir, _ = traced_align
    events = json.loads((tdir / profiling.TRACE_FILE).read_text())
    ranges = _mvs_ranges(events["traceEvents"])
    assert len(ranges) == len(job.spans)
    for s in job.spans:
        (r,) = [r for r in ranges
                if r["name"] == profiling.RANGE_PREFIX + s.name]
        dur = r["dur"] * 1e-6
        assert abs(dur - s.seconds) <= max(0.05 * s.seconds, 1e-3), s.name


def test_trace_flag_writes_the_trace_and_the_spans(traced_align):
    (job,), root, tdir, plain = traced_align
    d = json.loads((tdir / profiling.SPANS_FILE).read_text())
    (jd,) = d["jobs"]
    assert [s["name"] for s in jd["spans"]] == [s.name for s in job.spans]
    assert jd["counters"] == job.counters
    assert jd["spans"][0]["start_s"] == 0.0
    written = {f for _, _, fs in os.walk(root) for f in fs}
    assert {profiling.TRACE_FILE, profiling.SPANS_FILE} <= written
    for dirpath, _, fs in os.walk(root):
        if not dirpath.startswith(str(tdir)):
            assert profiling.TRACE_FILE not in fs
            assert profiling.SPANS_FILE not in fs
    assert (plain / "Result" / "Model.obj").exists()


@pytest.mark.parametrize("z_sheet,halo_copies", [(10.3, 0), (31.5, 1)])
def test_weld_counters_on_a_slab_extraction(z_sheet, halo_copies):
    """The sheet of test_slab_extraction_keeps_a_sheet_past_the_jax_caps
    (a 384-wide grid, slabs of 32): inside one slab no vertex is
    duplicated; in the cell layer both slabs hold (31, the first slab's
    last and the second's halo) every vertex comes into the weld twice.
    The weld's count is the welded mesh's either way."""
    from multiviewstitch_tpu_torch.ops import poisson as TP
    gz, g = 40, 384
    z = torch.arange(gz, dtype=torch.float32)
    field = (z_sheet - z)[:, None, None].expand(gz, g, g).contiguous()
    occ = torch.ones(field.shape, dtype=torch.bool)
    before = profiling.counters("poisson.")
    with recording() as rec:
        with span("job"):
            vs, fs = TP._extract_mesh_slabs(field, occ, torch.zeros(3), 1.0,
                                            slab=32)
    (job,) = rec.jobs()
    c = job.counters
    assert len(vs) == (g - 1) ** 2
    assert c["poisson.slabs"] == 2
    assert c["poisson.vertices"] == len(vs)
    assert c["poisson.slab_vertices"] == (1 + halo_copies) * len(vs)
    names = [s.name for s in job.spans]
    assert names.count("poisson.slab") == 2 and names.count(
        "poisson.weld") == 1
    after = profiling.counters("poisson.")
    assert after["poisson.vertices"] - before.get("poisson.vertices", 0) \
        == len(vs)


def test_counts_and_spans_from_many_threads_lose_nothing():
    import sys
    import threading
    n_threads, n = 16, 2000
    before = profiling.counters("t.stress").get("t.stress", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with recording() as rec:
            def work():
                for _ in range(n):
                    with span("outer"):
                        with span("inner"):
                            count("t.stress")
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert profiling.counters("t.stress")["t.stress"] - before == \
        n_threads * n
    by_id = {s.id: s for s in rec.spans}
    assert len(by_id) == len(rec.spans) == 2 * n_threads * n
    for s in rec.spans:
        if s.name == "inner":
            assert by_id[s.parent].name == "outer"
            assert by_id[s.parent].start_ns <= s.start_ns
        else:
            assert s.parent is None

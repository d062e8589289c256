"""PyTorch port, the program's own spans and counters
(``runtime/profiling.py``: ``span``, ``count``, ``span_totals``) on the CPU:
the off path, the records a traced frame holds, the engines' counters
against what a frame returns, the set-up spans, the graph capture's span,
the kernel library's first load on threads, and the benchmark's five
readers of them (``rtbench/metrics``) on synthetic traces."""

import json
import os
import sys
import threading
import time
import types
from unittest import mock

import pytest
import torch

from raytracing_course_2024_tpu_torch.integrator import wavefront as W
from raytracing_course_2024_tpu_torch.ops import kernels
from raytracing_course_2024_tpu_torch.runtime import profiling as P
from raytracing_course_2024_tpu_torch.runtime.graphs import Graphed
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from raytracing_course_2024_tpu_torch.scene import load_scene
from rtbench import registry, spans
from rtbench.trace import FRAME_SPAN, Trace

CORNELL = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes",
                       "cornell_box.gltf")
W_, H_, SPP = 16, 9, 2


@pytest.fixture(autouse=True)
def fresh_table():
    P.reset_spans()
    yield
    P.reset_spans()


def _renderer(engine="batch", backend=None, batch_size=96):
    return Renderer(load_scene(CORNELL, W_, H_, SPP), device="cpu", engine=engine,
                    backend=backend, batch_size=batch_size)


def _records(log_dir):
    with open(os.path.join(log_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("name", "").startswith("rt.")]


# --- the facility ----------------------------------------------------------------------


def test_a_span_without_a_profiler_counts_and_times(monkeypatch):
    """No profiler: no record is made, and the table counts each call and
    its host seconds; ``count`` adds to the same table."""
    monkeypatch.setattr(P, "_FAST", mock.Mock(side_effect=AssertionError("recorded")))
    clock = iter([10.0, 10.25, 20.0, 20.5])
    monkeypatch.setattr(P.time, "perf_counter", lambda: next(clock))
    for _ in range(2):
        with P.span("t.phase", frame=3):
            pass
    P.count("t.items", 5)
    P.count("t.items", 2)
    assert P.span_totals() == {"t.phase": [2, 0.75], "t.items": [7, 0.0]}
    table = P.span_totals()
    table["t.items"][0] = 0  # a copy
    assert P.SPANS["t.items"] == [7, 0.0]
    P.reset_spans()
    assert P.span_totals() == {}


def test_a_traced_batch_frame_nests_its_spans_in_the_frame(tmp_path):
    """Under a profiler that records shapes a batch-engine frame's
    ``rt.frame`` record encloses its batches' ``rt.batch.prep`` and
    ``rt.batch.fold`` and its ``rt.frame.sync``; the frame's number is in
    the record's args."""
    from torch.profiler import ProfilerActivity, profile

    r = _renderer()
    r.render_frame_device(seed=1)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        r.render_frame_device(seed=2)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    recs = _records(str(tmp_path))
    frames = [e for e in recs if e["name"] == "rt.frame"]
    assert len(frames) == 1 and frames[0]["args"]["frame"] == 1
    f0, f1 = frames[0]["ts"], frames[0]["ts"] + frames[0]["dur"]
    inner = [e for e in recs if e["name"] != "rt.frame"]
    assert {e["name"] for e in inner} == {"rt.batch.prep", "rt.batch.fold", "rt.frame.sync"}
    assert sum(e["name"] == "rt.batch.prep" for e in inner) == 2  # 144 pixels, 96 lanes
    assert all(f0 <= e["ts"] and e["ts"] + e["dur"] <= f1 for e in inner)
    assert P.span_totals()["rt.frame"][0] == 2


@pytest.mark.parametrize("engine", ["wavefront", "sticky"])
def test_the_loop_waits_are_the_host_reads(engine, tmp_path):
    """A lane frame's ``rt.loop.wait`` spans, in the table and in the
    trace, are its host reads (``HOST_READS``), one each; its reset and
    finish are one span each (the sticky engine on a lane a pixel: the K5
    loop's plain version)."""
    r = _renderer(engine, batch_size=64 if engine == "wavefront" else W_ * H_)
    reads = W.HOST_READS[0]
    with P.device_trace(str(tmp_path)):
        r.render_frame_device(seed=5)
    reads = W.HOST_READS[0] - reads
    table = P.span_totals()
    assert reads > 1 and table["rt.loop.wait"][0] == reads
    names = [e["name"] for e in _records(str(tmp_path))]
    assert names.count("rt.loop.wait") == reads
    assert names.count("rt.loop.reset") == names.count("rt.loop.finish") == 1


@pytest.mark.parametrize("backend", ["dense", "bvh"])
def test_building_a_renderer_spans_its_set_up(backend):
    _renderer("wavefront", backend)
    table = P.span_totals()
    for name in ("rt.setup.scene", "rt.setup.device"):
        assert table[name][0] == 1 and table[name][1] > 0.0
    assert ("rt.setup.bvh" in table) == (backend == "bvh")


@pytest.mark.parametrize("engine", ["batch", "wavefront", "sticky"])
def test_the_frame_counters_hold_the_frames_work(engine):
    """``rt.path_vertices`` is the count the frames return;
    ``rt.lane_slots`` is lanes x levels x samples on the batch engine
    (two batches of 96 lanes) and lanes x rounds on the lane engines."""
    r = _renderer(engine)
    verts, slots = 0.0, 0
    for seed in (1, 2):
        _, v = r.render_frame_device(seed=seed)
        verts += v
        slots += (2 * 96 * r.cfg.ray_depth * SPP if engine == "batch" else 96 * r.rounds)
    table = P.span_totals()
    assert table["rt.path_vertices"][0] == verts > 0
    assert table["rt.lane_slots"][0] == slots
    assert 0 < verts < slots


def test_a_graph_entry_spans_its_capture_only():
    capture = mock.Mock(return_value=(lambda: None, {}, {"capture_ms": 1.0}))
    g = Graphed(lambda: None, torch.device("cpu"), capture)
    for _ in range(3):
        g()
    assert capture.call_count == 1 and g.replays == 2
    assert P.span_totals()["rt.graph.capture"][0] == 1


# --- the kernel library's first load on threads ----------------------------------------


def test_the_library_loads_once_across_threads(monkeypatch):
    builds = []
    gate = threading.Barrier(4)

    def build():  # slow enough that every thread asks before it ends
        builds.append(threading.get_ident())
        time.sleep(0.05)
        return "stub.so"

    monkeypatch.setattr(kernels, "_LIB", None)
    monkeypatch.setattr(kernels, "_build", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: mock.MagicMock())
    got = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: (gate.wait(5), got.append(kernels.library())))
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(builds) == 1 and len(got) == 4 and all(lib is got[0] for lib in got)
    assert P.span_totals()["rt.setup.library"][0] == 1


FAKE_NVCC = """#!/bin/sh
out=""; prev=""; shared=0
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  [ "$a" = "-shared" ] && shared=1
  prev="$a"
done
if [ $shared = 1 ]; then
  for a in "$@"; do
    case "$a" in *.o) [ -f "$a" ] || { echo "could not open $a"; exit 1; };; esac
  done
fi
echo "$out" >> "$FAKE_NVCC_LOG"
: > "$out"
"""


def test_builds_on_threads_name_their_own_objects(monkeypatch, tmp_path):
    """Four threads build at once (no lock, a stand-in nvcc that refuses to
    link an object that is gone): each names its objects by process and
    thread, so none removes another's, and every build links."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    log = tmp_path / "outputs.log"
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(kernels, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    gate = threading.Barrier(4)
    errors = []

    def build():
        gate.wait(5)
        try:
            kernels._build()
        except RuntimeError as e:
            errors.append(str(e))

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and errors == []
    objs = [p for p in log.read_text().split() if p.endswith(".o")]
    assert len(objs) % len(kernels.SOURCES) == 0 and len(set(objs)) == len(objs)
    assert list((tmp_path / "build").glob("*.o")) == []
    assert len(list((tmp_path / "build").glob("rt_kernels_*.so"))) == 1


# --- the benchmark's readers -----------------------------------------------------------


def _ev(name, t0_ms, t1_ms, cat):
    return {"name": name, "ts": t0_ms * 1e3, "dur": (t1_ms - t0_ms) * 1e3, "cat": cat,
            "ph": "X", "args": {"device": 0}}


def _synthetic():
    """Two frames of 10 ms. Device busy 1-7 and 8.5-9 ms, then 10.2-19 ms.
    Program spans: frame 1 ``rt.frame`` 0.5-9.5 with ``rt.batch.prep``
    0.5-1.5 and ``rt.frame.sync`` 8-9.4; frame 2 ``rt.frame`` 10.1-19.8 with
    ``rt.loop.wait`` 18.5-19.5; an ATen op inside the first frame's idle."""
    return Trace([_ev(FRAME_SPAN, 0, 10, "user_annotation"),
                  _ev(FRAME_SPAN, 10, 20, "user_annotation"),
                  _ev("bounce_kernel", 1, 7, "kernel"),
                  _ev("Memcpy DtoD", 8.5, 9, "gpu_memcpy"),
                  _ev("bounce_kernel", 10.2, 19, "kernel"),
                  _ev("rt.frame", 0.5, 9.5, "cpu_op"),
                  _ev("rt.batch.prep", 0.5, 1.5, "cpu_op"),
                  _ev("aten::copy_", 7.5, 8.0, "cpu_op"),
                  _ev("rt.frame.sync", 8, 9.4, "cpu_op"),
                  _ev("rt.frame", 10.1, 19.8, "user_annotation"),
                  _ev("rt.loop.wait", 18.5, 19.5, "user_annotation")])


class _Ctx:
    def __init__(self, trace, frames=2):
        self.trace, self.frames, self.notes = trace, frames, []
        self.cell = types.SimpleNamespace(chips=1)

    def note(self, line):
        self.notes.append(line)

    def delta(self, name):
        return 0


def test_the_idle_readers_split_the_idle_time_by_span():
    """Idle 0-1, 7-8.5, 9-10, 10-10.2, 19-20 ms (4.7 ms). By span: outside
    any 0-0.5, 9.5-10, 10-10.1, 19.8-20 (1.3); ``rt.frame`` 7-8, 9.4-9.5,
    10.1-10.2, 19.5-19.8 (1.5, the ATen op inside counts as its frame's);
    sync 8-8.5, 9-9.4 (0.9); prep 0.5-1 (0.5, the innermost of two spans
    that start together); wait 19-19.5 (0.5)."""
    tr = _synthetic()
    split = spans.idle_by_span(tr)
    want = {"none": 1.3, "rt.frame": 1.5, "rt.frame.sync": 0.9, "rt.batch.prep": 0.5,
            "rt.loop.wait": 0.5}
    assert split == {k: pytest.approx(v * 1e-3) for k, v in want.items()}
    ctx = _Ctx(tr)
    boundary = registry.reader("boundary_idle_ms").read(ctx)
    engine = registry.reader("engine_idle_ms").read(ctx)
    assert boundary == pytest.approx(3.7 / 2) and engine == pytest.approx(1.0 / 2)
    # the two make up the window's idle time, as device_idle_pct reads it
    idle_pct = registry.reader("device_idle_pct").read(ctx)
    assert (boundary + engine) * ctx.frames == pytest.approx(idle_pct / 100 * tr.window_s * 1e3)
    assert len(ctx.notes) == 2
    assert "rt.frame.sync" in ctx.notes[0] and "rt.loop.wait" in ctx.notes[1]


def test_the_innermost_span_is_the_latest_open():
    """Spans from two threads overlap: the latest to start is the one
    open; time in none is outside."""
    segs = spans.segments([("rt.shard", 0, 10), ("rt.shard", 2, 6), ("rt.frame", 4, 12)])
    assert segs == [(0, 2, "rt.shard"), (2, 4, "rt.shard"), (4, 6, "rt.frame"),
                    (6, 10, "rt.frame"), (10, 12, "rt.frame")]
    assert spans.segments([("rt.a", 0, 1), ("rt.b", 2, 3)])[1] == (1, 2, "none")


def test_the_idle_readers_read_nothing_without_program_spans():
    tr = Trace([_ev(FRAME_SPAN, 0, 10, "user_annotation"), _ev("k", 1, 2, "kernel")])
    for name in ("boundary_idle_ms", "engine_idle_ms"):
        assert registry.reader(name).read(_Ctx(tr, 1)) is None


def test_the_table_readers(monkeypatch):
    monkeypatch.setattr(P, "SPANS", {
        "rt.lane_slots": [200, 0.0], "rt.path_vertices": [104.0, 0.0], "rt.frame": [3, 0.1],
        "rt.setup.scene": [1, 1.5], "rt.setup.bvh": [1, 2.0], "rt.setup.device": [2, 0.25],
        "rt.setup.library": [1, 3.0], "rt.graph.capture": [3, 0.6]})
    ctx = _Ctx(_synthetic())
    assert registry.reader("lane_occupancy_pct").read(ctx) == pytest.approx(52.0)
    assert registry.reader("scene_setup_s").read(ctx) == pytest.approx(3.75)
    assert registry.reader("graph_setup_s").read(ctx) == pytest.approx(0.6)
    assert "rt.setup.library" in ctx.notes[1]


def test_the_table_readers_read_nothing_from_a_program_without_the_table(monkeypatch):
    monkeypatch.setitem(sys.modules, "raytracing_course_2024_tpu_torch.runtime.profiling",
                        types.ModuleType("profiling"))
    for name in ("lane_occupancy_pct", "scene_setup_s", "graph_setup_s"):
        assert registry.reader(name).read(_Ctx(_synthetic())) is None

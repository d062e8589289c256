"""Tests of the benchmark, on the CPU: ``python3 -m pytest rtbench -q``.

The contract's shape of ``BENCHMARK.json``, the files every cell names, the
per-layer readers on a synthetic trace, the modules a run loads, the
reference against the program's CPU render of a tiny frame of each
configuration, the control (the reference in bfloat16) failing the check,
and a run driven with its timed path broken coming out not correct. The
tests that need a card are marked ``cuda`` and decide inside the test
whether one is present.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtbench import check, registry, run, scenes
from rtbench.reference import tracer
from rtbench.reference.rng import frame_seed32
from rtbench.trace import FRAME_SPAN, Trace

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TINY = {"cornell_box": (24, 14, 2), "mesh100k": (16, 9, 1)}


def test_benchmark_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    names += [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = registry.Cell(cell, BENCH)
    assert c.traffic["width"] > 0 and c.config["scene"]["kind"]
    assert set(c.settings["check"]["limits"]) == {"pixel_mismatch_pct", "verts_rel_err_pct"}
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.per_layer:
        mod = registry.reader(m["name"])
        assert mod.UNIT == m["unit"] and mod.LAYER == m["layer"] and m["moves"] in reported
    for m in BENCH["per_layer"]:
        if cell in m.get("workloads", [cell]):
            assert m["moves"] in reported, (m["name"], cell)


def test_config_files_hold_their_reductions():
    for c in BENCH["configs"]:
        conf = json.load(open(os.path.join(registry.ROOT, c["file"])))
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_builds_the_triangles_it_states(config):
    folder = os.path.join(registry.HERE, "configs")
    conf = json.load(open(os.path.join(folder, f"{config}.json")))
    spec = scenes.build(conf["scene"], folder, 8, 4)
    assert int((spec.prims["kind"] == scenes.TRI).sum()) == conf["triangles"]


def test_vase_is_closed_at_its_pole_and_faces_out():
    from rtbench.scenes.displaced_sphere import vase
    vs, fa, vn = vase(121, 75, 0.3, 0.8, [0.0, 0.0, 0.0])
    assert len(fa) == 121 * 149 and len(vs) == 1 + 121 * 75
    radial = vs * np.array([1.0, 0.0, 1.0])
    assert ((vn[1:] * radial[1:]).sum(1) > 0).all()
    assert np.allclose(vn[0], [0.0, -1.0, 0.0])


# --- per-layer readers on a synthetic trace ------------------------------------


def _ev(name, ts, dur, cat, device=0):
    return {"name": name, "ts": ts, "dur": dur, "cat": cat, "ph": "X", "args": {"device": device}}


class _Ctx:
    def __init__(self, trace, cell, spec, verts, rounds, c0, c1, chips=1):
        self.trace, self.cell, self.spec, self.verts, self.rounds = trace, cell, spec, verts, rounds
        self.counters0, self.counters1 = c0, c1
        self.frames = len(rounds)
        self.kind, self.power, self.engine = "NVIDIA H100 80GB HBM3", "700 W", "batch"
        self.peaks = registry.peaks(self.kind)
        self.notes = []
        self.cell.chips = chips

    def note(self, line):
        self.notes.append(line)

    def delta(self, name):
        return self.counters1[name] - self.counters0[name]


def _synthetic():
    """Two frames of 10 ms; device busy 0-4 and 5-8 ms in frame 1 (kernels
    A, B, a copy), 12-17 ms in frame 2 (kernel B); the host in an op from
    8 to 9 ms."""
    ev = [_ev(FRAME_SPAN, 0, 10_000, "user_annotation"),
          _ev(FRAME_SPAN, 10_000, 10_000, "user_annotation"),
          _ev("primary_kernel(float*)", 0, 4_000, "kernel"),
          _ev("bounce_kernel<false>(float*)", 5_000, 2_000, "kernel"),
          _ev("Memcpy DtoD", 7_000, 1_000, "gpu_memcpy"),
          _ev("bounce_kernel<true>(float*)", 12_000, 5_000, "kernel"),
          _ev("aten::item", 8_000, 1_000, "cpu_op")]
    return Trace(ev)


def test_trace_readers_on_a_synthetic_trace():
    tr = _synthetic()
    cell = registry.Cell("cornell.720p32", BENCH)
    spec = scenes.build(cell.config["scene"], cell.config_dir, 1280, 720)
    ctx = _Ctx(tr, cell, spec, 3.0e6, [0, 0], {"graph_entries": 5, "host_reads": 7,
                                             "launches": 10},
               {"graph_entries": 5, "host_reads": 13, "launches": 16})
    assert tr.window_s == pytest.approx(0.020)
    assert tr.frame_busy_s() == pytest.approx([0.007, 0.005])
    # frame wall 10 ms less 7 and 5 ms busy: 3 and 5 ms
    assert registry.reader("host_ms_per_frame").read(ctx) == pytest.approx(4.0)
    # busy 12 of 20 ms
    assert registry.reader("device_idle_pct").read(ctx) == pytest.approx(40.0)
    assert registry.reader("launches_per_frame").read(ctx) == pytest.approx(1.5)
    assert registry.reader("graph_captures").read(ctx) == 0
    assert registry.reader("host_reads_per_frame").read(ctx) == pytest.approx(3.0)
    assert tr.device_s_by_name(("bounce_kernel",)) == pytest.approx(0.007)
    gaps = dict((n, v) for n, v in tr.idle_gaps())
    # idle 4-5 and 17-20 ms inside the frames' spans, 8-12 ms from inside the op
    assert gaps == {"aten::item": pytest.approx(0.004), FRAME_SPAN: pytest.approx(0.004)}
    assert [n for n, _ in tr.top_ops()][:1] == ["bounce_kernel"]


def test_lane_rounds_sum_the_shards():
    ctx = _Ctx(_synthetic(), registry.Cell("mesh100k.720p32", BENCH), None, 0.0,
               [[[10, 12], [11, 13]], [[10, 10], [10, 10]]], {}, {})
    assert registry.reader("lane_rounds_per_frame").read(ctx) == pytest.approx(43.0)


def test_idle_counts_a_card_without_intervals():
    ctx = _Ctx(_synthetic(), registry.Cell("mesh100k.720p32", BENCH), None, 0.0, [0, 0], {}, {},
               chips=4)
    assert registry.reader("device_idle_pct").read(ctx) == pytest.approx(100.0)


def test_bounce_roofline_by_hand():
    tr = _synthetic()
    cell = registry.Cell("cornell.720p32", BENCH)
    spec = scenes.build(cell.config["scene"], cell.config_dir, 1280, 720)
    ref = tracer.Scene(spec, "cpu")
    spp = cell.traffic["spp"]
    verts = 2 * spp * 921_600 * 3.0  # two frames, three vertices a path
    ctx = _Ctx(tr, cell, spec, verts, [0, 0], {}, {})
    ctx.ref_scene = ref
    paths = 2 * spp * 921_600
    nbytes = (paths * (64 + 4 * 28 + 4) + 76 * (verts - paths)
              + 2 * spp * 6 * (36 * 36 + 19 * 2) * 4)
    ops = verts * (53 * 36 + 18)
    least = max(nbytes / 3.35e12, ops / 67e12)
    dev_s = 0.004 + 0.002 + 0.005
    assert registry.reader("bounce_roofline").read(ctx) == pytest.approx(100 * least / dev_s)


def test_dense_nearest_roofline_by_hand():
    tr = Trace([_ev(FRAME_SPAN, 0, 10_000, "user_annotation"),
                _ev("dense_nearest_kernel", 1_000, 2_000, "kernel")])
    cell = registry.Cell("cornell.720p32.rr", BENCH)
    spec = scenes.build(cell.config["scene"], cell.config_dir, 1280, 720)
    ctx = _Ctx(tr, cell, spec, 1.0e7, [0], {}, {})
    want = 100 * max(1e7 * 33 / 3.35e12, 1e7 * 36 * 53 / 67e12) / 0.002
    assert registry.reader("dense_nearest_roofline").read(ctx) == pytest.approx(want)


def test_a_roofline_with_no_kernel_reads_nothing():
    tr = Trace([_ev(FRAME_SPAN, 0, 10_000, "user_annotation")])
    cell = registry.Cell("cornell.720p32.rr", BENCH)
    spec = scenes.build(cell.config["scene"], cell.config_dir, 1280, 720)
    assert registry.reader("dense_nearest_roofline").read(
        _Ctx(tr, cell, spec, 1e7, [0], {}, {})) is None


# --- what a run loads ----------------------------------------------------------------


def test_forbidden_names_compare_whole():
    sys.modules.setdefault("raytracing_course_2024_tpu_torchx", sys)
    try:
        assert "raytracing_course_2024_tpu_torchx" not in run.forbidden_modules()
    finally:
        del sys.modules["raytracing_course_2024_tpu_torchx"]
    assert not [m for m in run.forbidden_modules() if m.startswith("rtbench")]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; from rtbench import run, control, registry, program;"
            "[registry.reader(m['name']) for m in registry.benchmark()['per_layer']];"
            "from rtbench.scenes import build;"
            "c = registry.Cell('cornell.720p32');"
            "s = build(c.config['scene'], c.config_dir, 8, 4);"
            "program.System(s, 1, 1, 'dense', 4, False, device='cpu').frame(1);"
            "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, capture_output=True,
                         text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# --- the reference against the program ------------------------------------------------


def _port_frame(cell: str, seed: int):
    from rtbench.program import System
    c = registry.Cell(cell, BENCH)
    w, h, spp = TINY[c.entry["config"]]
    spec = scenes.build(c.config["scene"], c.config_dir, w, h)
    sysm = System(spec, spp, 1, c.config["backend"], c.config["max_tries"],
                  c.traffic["russian_roulette"], device="cpu")
    img, verts = sysm.frame(run.frame_seed(seed, 0))
    return c, spec, spp, sysm.engine, img, verts


@pytest.mark.parametrize("cell", ["cornell.720p32", "cornell.720p32.rr", "mesh100k.720p32"])
def test_reference_agrees_with_the_program_on_the_cpu(cell):
    c, spec, spp, engine, img, verts = _port_frame(cell, 3_000_000_019)
    s = tracer.Scene(spec, "cpu", tree=c.config["backend"] == "bvh")
    n = spec.width * spec.height
    ref, rv = tracer.render_pixels(s, frame_seed32(run.frame_seed(3_000_000_019, 0)),
                                   torch.arange(n), spp, engine != "batch",
                                   c.config["max_tries"], c.traffic["russian_roulette"])
    assert float(rv.sum()) == verts
    nums = check.compare([(img, verts)], [(ref, rv.sum())], n, n)
    assert nums == {"pixel_mismatch_pct": 0.0, "verts_rel_err_pct": 0.0}
    assert torch.allclose(img, ref, rtol=1e-5, atol=1e-6)


def test_control_in_bfloat16_fails_the_check():
    """The control at a size a test holds: the reference in bfloat16 in the
    program's place, on the cell's pixels (all of a 48x27 frame)."""
    c = registry.Cell("cornell.720p32", BENCH)
    spec = scenes.build(c.config["scene"], c.config_dir, 48, 27)
    n = spec.width * spec.height
    pix = torch.arange(n)
    seed32 = frame_seed32(run.frame_seed(2**31 + 5, 0))
    r32, v32 = tracer.render_pixels(tracer.Scene(spec, "cpu"), seed32, pix, 4, False, 4, False)
    r16, v16 = tracer.render_pixels(tracer.Scene(spec, "cpu", torch.bfloat16), seed32, pix, 4,
                                    False, 4, False)
    nums = check.compare([(r16, float(v16.sum()))], [(r32, v32.sum())], n, n)
    assert not check.verdict(nums, c.settings["check"]["limits"]), nums


# --- a run with its timed path broken -----------------------------------------------


def _small_cell(monkeypatch, w, h, spp, pixels=None):
    """The cell at a frame of w x h and ``spp``, two traced frames, judging
    ``pixels`` of it (all, as the Cornell cells judge theirs)."""
    orig = registry.Cell.__init__

    def small(self, name, bench=None):
        orig(self, name, bench)
        self.traffic = dict(self.traffic, width=w, height=h, spp=spp)
        self.settings = dict(self.settings, trace_frames=2,
                             check=dict(self.settings["check"], pixels=pixels or w * h))

    monkeypatch.setattr(registry.Cell, "__init__", small)


def _run(capsys, cell, seed=4_000_000_007, trace=0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0.5", "--trace",
                   str(trace)], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


def _broken(monkeypatch, fault):
    from rtbench.program import System
    real = System.frame
    last = {}

    def frame(self, seed):
        img, verts = real(self, seed)
        if fault == "unchanged":  # returns the state of the frame before
            prev = last.get("img", img)
            last["img"] = img.clone()
            return prev, last.setdefault("verts", verts)
        if fault == "half":  # half the samples left out, the mean over the rest
            h_img, h_verts = self.r.render_frame_device(seed=seed, samples=self.samples // 2)
            return h_img[0], float(h_verts)
        if fault == "altered":  # an answer altered where it is produced
            return img * 1.01, verts
        if fault == "exchange":  # the second tile's rows never reach the first card
            out = img.clone()
            out[:, out.shape[1] // 2:] = 0.0
            return out, verts
        raise ValueError(fault)

    monkeypatch.setattr(System, "frame", frame)


def test_a_sound_run_is_correct(monkeypatch, capsys):
    _small_cell(monkeypatch, 24, 14, 2)
    res = _run(capsys, "cornell.720p32")
    assert res["correct"] and list(res)[-1] == "check"
    assert set(res["metrics"]) == {"mrays_per_s", "frame_ms_p95", "setup_s"}


def test_a_traced_run_reports_the_per_layer_metrics(monkeypatch, capsys):
    _small_cell(monkeypatch, 24, 14, 2)
    res = _run(capsys, "cornell.720p32", trace=1)
    assert res["correct"] and "busy_s" in res["device"] and "window_s" in res["device"]
    assert {"host_ms_per_frame", "graph_captures", "launches_per_frame"} <= set(res["metrics"])
    # the traced window is its traced frames, not --seconds of them
    assert res["attempted"] == 2


def test_the_walk_model_takes_pixels_from_the_whole_frame(monkeypatch):
    mod = registry.reader("bvh_nearest_roofline")
    seen = {}

    def trace(s, seed32, wid, px, py, layout, rr, levels):
        seen["py"] = py
        raise StopIteration

    monkeypatch.setattr(mod.tracer, "trace", trace)
    cell = registry.Cell("mesh100k.720p32", BENCH)

    class Ctx:
        ref_scene = type("S", (), {"spec": type("P", (), {"width": 1280})()})()
        pixels = torch.from_numpy(check.judged_pixels(9, 921_600, 65_536))
        seed32, engine = 1, "wavefront"

    Ctx.cell = cell
    with pytest.raises(StopIteration):
        mod.ops_per_ray(Ctx())
    rows = seen["py"]
    assert rows.shape[0] == mod.WALK_PIXELS and rows.min() < 8 and rows.max() > 711


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, capsys, fault):
    _small_cell(monkeypatch, 24, 14, 4)
    _broken(monkeypatch, fault)
    assert not _run(capsys, "cornell.720p32")["correct"]


def test_a_sharded_run_without_its_exchange_is_not_correct(monkeypatch, capsys):
    """The four-card cell's files (left out of BENCHMARK.json: PERF.md §7) on
    a mesh of four CPU devices."""
    four = {"name": "mesh100k.720p256.4card", "config": "mesh100k", "traffic": "720p256",
            "chips": 4, "why": "the sharded frame and its combine"}
    bench = dict(BENCH, workloads=BENCH["workloads"] + [four])
    monkeypatch.setattr(registry, "benchmark", lambda: bench)
    _small_cell(monkeypatch, 12, 8, 2)
    assert _run(capsys, "mesh100k.720p256.4card")["correct"]
    _broken(monkeypatch, "exchange")
    assert not _run(capsys, "mesh100k.720p256.4card")["correct"]


def test_judged_pixels_and_reservoir_follow_the_seed():
    a = check.judged_pixels(2**31 + 77, 921_600, 4096)
    assert np.array_equal(a, check.judged_pixels(2**31 + 77, 921_600, 4096))
    assert not np.array_equal(a, check.judged_pixels(2**31 + 78, 921_600, 4096))
    # one pixel in each of 4,096 equal runs of the frame: sorted, distinct, every row band
    assert np.array_equal(a // 225, np.arange(4096)) and (np.diff(a) > 0).all()
    assert np.array_equal(check.judged_pixels(5, 921_600, 921_600), np.arange(921_600))
    hits = np.zeros(50)
    for s in range(400):
        r = check.Reservoir(2, s)
        kept = {}
        for i in range(50):
            j = r.slot(i)
            if j is not None:
                kept[j] = i
        hits[list(kept.values())] += 1
    assert hits.min() > 0 and hits.max() < 40  # 16 expected a frame


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's kernels run only there")
    out = subprocess.run([sys.executable, "-m", "rtbench.run", "--workload", "cornell.720p32",
                          "--seed", "2147483999", "--seconds", "2", "--trace", "0"],
                         cwd=registry.ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]

"""PyTorch port, rendering across processes (``parallel/shard.py``:
``init_distributed``, ``make_multihost_mesh``, ``render_frame_sharded`` over
a mesh that spans processes; ``render_with_checkpoints`` and the CLI in a
process group).

The mesh layout is checked against a faked per-process device list, as the
JAX package's ``test_multihost_mesh_layout`` fakes it. The frames are
rendered by real process groups: worker processes of this file (``python
tests/test_torch_multihost.py CASE DIR STORE WORLD RANK``) join a gloo group
over a ``file://`` store in the test's directory, so that no port can clash,
render with ``torch.set_num_threads(1)`` on ``cpu`` devices and never import
``jax``. Each world runs under a timeout: a hung collective fails its test
and stalls nothing else. A frame across processes must equal, bit for bit,
the frame of the same mesh in one process, which each world's process 0
renders under the same thread count (a CPU reduction may split otherwise).
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
SEED = 5
ENGINES = ("batch", "wavefront", "sticky")
W, H, SPP = 16, 12, 4
CKPT_SPP, CKPT_CHUNK = 4, 2
WORKER_TIMEOUT = 150  # seconds for a whole world; each takes 5-15 s on an idle CPU
LAUNCHER_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                 "MASTER_PORT", "GROUP_RANK", "TORCHELASTIC_USE_AGENT_STORE")


# --- the workers (run as ``python tests/test_torch_multihost.py ...``) -----


def _desc(out: Path):
    from raytracing_course_2024_tpu_torch.scene import parse_text_scene

    desc = parse_text_scene((out / "scene.txt").read_text())
    desc.settings.width, desc.settings.height, desc.settings.samples = W, H, SPP
    return desc


def _frame(sr):
    img, stats = sr.render_radiance(seed=SEED, with_stats=True)
    return img, stats.path_vertices, np.asarray(sr.rounds)


class _Stop(RuntimeError):
    pass


class _StopAt:
    """A renderer as ``render_with_checkpoints`` sees it, raising in place of
    chunk ``stop``."""

    def __init__(self, renderer, stop):
        self.r, self.stop, self.chunks = renderer, stop, 0

    def __getattr__(self, name):
        return getattr(self.r, name)

    def render_radiance(self, seed, samples):
        if self.chunks == self.stop:
            raise _Stop(f"chunk {self.stop}")
        self.chunks += 1
        return self.r.render_radiance(seed=seed, samples=samples)


def _worker(case: str, out: Path, store: str, world: int, rank: int) -> None:
    torch.set_num_threads(1)
    from raytracing_course_2024_tpu_torch.parallel import (init_distributed, make_mesh,
                                                           make_multihost_mesh)
    from raytracing_course_2024_tpu_torch.runtime import checkpoint as C
    from raytracing_course_2024_tpu_torch.runtime import profiling as P
    from raytracing_course_2024_tpu_torch.runtime.render import ShardedRenderer

    save = np.savez  # process 0 alone may write checkpoints: the others lose np.savez
    if not init_distributed(store, world, rank):
        raise SystemExit("init_distributed did not start a group")
    if dist.get_backend() != "gloo":
        raise SystemExit(f"backend {dist.get_backend()} without cards")
    got = {}
    if case == "engines":  # (4, 2) over 4 processes of 2 devices each
        mesh = make_multihost_mesh(4, 2, devices=["cpu"] * 2)
        got["ranks"] = np.asarray(mesh.ranks)
        for engine in ENGINES:
            for key, m in (("", mesh), ("ref-", make_mesh(4, 2, ["cpu"] * 8))):
                if key and rank:
                    continue
                sr = ShardedRenderer(_desc(out), mesh=m, engine=engine)
                P.reset_spans()
                img, verts, rounds = _frame(sr)
                table = P.span_totals()
                got[f"{key}{engine}"] = img
                got[f"{key}{engine}-verts"], got[f"{key}{engine}-rounds"] = verts, rounds
                got[f"{key}{engine}-counters"] = np.asarray(
                    [table["rt.path_vertices"][0], table["rt.lane_slots"][0]], np.float64)
    elif case == "bvh":  # (2, 1), one device each, the BVH backend
        for key, m in (("", make_multihost_mesh(2, 1, devices=["cpu"])),
                       ("ref-", make_mesh(2, 1, ["cpu"] * 2))):
            if key and rank:
                continue
            sr = ShardedRenderer(_desc(out), mesh=m, backend="bvh")
            got[f"{key}backend"] = np.asarray(sr.backend)
            got[f"{key}frame"], got[f"{key}verts"], _ = _frame(sr)
    elif case in ("ckpt", "resume"):
        if rank:  # only process 0 may write a checkpoint
            def refuse(*a, **k):
                raise AssertionError("a process other than 0 wrote a checkpoint")
            C.np.savez = refuse
        desc = _desc(out)
        desc.settings.samples = CKPT_SPP
        sr = ShardedRenderer(desc, mesh=make_multihost_mesh(2, 1, devices=["cpu"]))
        if case == "ckpt":
            got["full"] = C.render_with_checkpoints(sr, str(out / "full.npz"), CKPT_SPP,
                                                    CKPT_CHUNK, seed=SEED)
            try:
                C.render_with_checkpoints(_StopAt(sr, 1), str(out / "cut.npz"), CKPT_SPP,
                                          CKPT_CHUNK, seed=SEED)
                raise SystemExit("the interruption did not happen")
            except _Stop:
                pass
        else:
            got["resumed"] = C.render_with_checkpoints(sr, str(out / "cut.npz"), CKPT_SPP,
                                                       CKPT_CHUNK, seed=SEED)
    elif case == "fail":  # process 0 fails to read, then to write: every process raises
        desc = _desc(out)
        desc.settings.samples = CKPT_SPP
        sr = ShardedRenderer(desc, mesh=make_multihost_mesh(2, 1, devices=["cpu"]))
        for what, path in (("read", out / "bad.npz"), ("write", out / "new.npz")):
            if what == "write" and rank == 0:
                def disk_full(*a, **k):
                    raise OSError("disk full")
                C.np.savez = disk_full
            try:
                C.render_with_checkpoints(sr, str(path), CKPT_SPP, CKPT_CHUNK, seed=SEED)
                got[what] = np.asarray("no error")
            except Exception as e:
                got[what] = np.asarray(f"{type(e).__name__}: {e}")
    elif case == "cli":  # main() renders in the group it finds
        from raytracing_course_2024_tpu_torch.runtime import cli

        os.chdir(out / "cli")
        rc = cli.main([str(out / "scene.txt"), str(W), str(H), str(SPP), "out.ppm", "out"],
                      device="cpu")
        got["rc"] = np.asarray(rc)
        if rank == 0:
            sr = ShardedRenderer(_desc(out), mesh=make_mesh(2, 1, ["cpu"] * 2))
            got["ref"] = sr.render_u8(0)
    else:
        raise SystemExit(f"unknown case {case}")
    dist.destroy_process_group()
    save(out / f"{case}-{rank}.npz", **got)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
    if leaked:
        raise SystemExit(f"the worker imported {leaked[:3]}")


# --- the tests ---------------------------------------------------------------


def _run_world(case: str, n: int, out: Path) -> list:
    """Run ``n`` workers of ``case`` in one gloo group; their results, by
    rank. Fails with a worker's output if one exits non-zero or the world
    outlives ``WORKER_TIMEOUT``."""
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_VARS}
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    env["OMP_NUM_THREADS"] = "1"
    store = out / f"{case}.store"
    logs = [out / f"{case}-{r}.log" for r in range(n)]
    procs = []
    try:
        for r in range(n):
            with open(logs[r], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, case, str(out), f"file://{store}", str(n), str(r)],
                    stdout=f, stderr=subprocess.STDOUT, env=env, cwd=out))
        deadline = time.monotonic() + WORKER_TIMEOUT
        while True:  # fail at the first non-zero exit: the others may wait on it
            codes = [p.poll() for p in procs]
            for r, code in enumerate(codes):
                if code not in (None, 0):
                    pytest.fail(f"{case}: process {r} of {n} exited {code}:\n"
                                + logs[r].read_text()[-4000:])
            if None not in codes:
                break
            if time.monotonic() > deadline:
                r = codes.index(None)
                pytest.fail(f"{case}: process {r} of {n} still ran after {WORKER_TIMEOUT} s:\n"
                            + logs[r].read_text()[-4000:])
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(out / f"{case}-{r}.npz")) for r in range(n)]


def _scene_dir(tmp_path_factory, name: str) -> Path:
    from test_megakernel import MIXED_SCENE

    out = tmp_path_factory.mktemp(name)
    (out / "scene.txt").write_text(MIXED_SCENE)
    return out


@pytest.fixture(scope="module")
def engines_world(tmp_path_factory):
    return _run_world("engines", 4, _scene_dir(tmp_path_factory, "engines"))


@pytest.fixture(scope="module")
def bvh_world(tmp_path_factory):
    return _run_world("bvh", 2, _scene_dir(tmp_path_factory, "bvh"))


@pytest.mark.parametrize("engine", ENGINES)
def test_four_processes_equal_one_process_bit_for_bit(engines_world, engine):
    """(4, 2) over 4 processes of 2 ``cpu`` devices: every process returns
    the single-process (4, 2) frame bit for bit, with its path vertices and
    rounds."""
    ref = engines_world[0]
    assert np.isfinite(ref[f"ref-{engine}"]).all() and ref[f"ref-{engine}"].max() > 0
    for rank, got in enumerate(engines_world):
        np.testing.assert_array_equal(got["ranks"], [[0, 0], [1, 1], [2, 2], [3, 3]])
        np.testing.assert_array_equal(got[engine], ref[f"ref-{engine}"], err_msg=f"rank {rank}")
        assert got[f"{engine}-verts"] == ref[f"ref-{engine}-verts"] > 0
        np.testing.assert_array_equal(got[f"{engine}-rounds"], ref[f"ref-{engine}-rounds"])
    if engine != "batch":
        assert (ref[f"ref-{engine}-rounds"] > 0).all()


@pytest.mark.parametrize("engine", ENGINES)
def test_each_process_counts_the_work_of_its_own_shards(engines_world, engine):
    """Each process of (4, 2) over 4 processes counts the path vertices and
    lane slots of its own shards: summed over the processes they are the
    single-process frame's, so each process's ``lane_occupancy_pct`` reads
    its own shards' ratio and not the group's vertices over its slots."""
    ref = engines_world[0]
    one = ref[f"ref-{engine}-counters"]
    assert one[0] == ref[f"ref-{engine}-verts"] and 0 < one[0] < one[1]
    each = np.stack([got[f"{engine}-counters"] for got in engines_world])
    assert (each > 0).all() and (each[:, 0] < each[:, 1]).all()
    np.testing.assert_array_equal(each.sum(axis=0), one)


def test_bvh_backend_on_two_processes(bvh_world):
    ref = bvh_world[0]
    assert str(ref["backend"]) == str(ref["ref-backend"]) == "bvh"
    for got in bvh_world:
        np.testing.assert_array_equal(got["frame"], ref["ref-frame"])
        assert got["verts"] == ref["ref-verts"] > 0


def test_checkpoint_resumes_across_processes_bit_for_bit(tmp_path_factory):
    """2 processes: a frame of 2 chunks, unbroken; the same stopped after one
    chunk, then resumed by a fresh pair of processes from process 0's file."""
    out = _scene_dir(tmp_path_factory, "ckpt")
    full = _run_world("ckpt", 2, out)
    with np.load(out / "cut.npz") as ck:
        assert int(ck["done_spp"]) == CKPT_CHUNK and int(ck["next_chunk"]) == 1
    resumed = _run_world("resume", 2, out)
    np.testing.assert_array_equal(full[1]["full"], full[0]["full"])
    for got in resumed:
        np.testing.assert_array_equal(got["resumed"], full[0]["full"])
    assert sorted(p.name for p in out.glob("*.npz") if "-" not in p.name) == ["cut.npz",
                                                                             "full.npz"]


def test_checkpoint_failure_on_process_0_raises_on_every_process(tmp_path_factory):
    """2 processes: process 0 cannot read ``bad.npz`` (a broken zip), then
    cannot write its first checkpoint; each time both processes raise, and
    none waits on the other."""
    out = _scene_dir(tmp_path_factory, "fail")
    (out / "bad.npz").write_bytes(b"PK\x03\x04" + bytes(64))
    lead, other = _run_world("fail", 2, out)
    assert str(lead["read"]).startswith("BadZipFile")
    assert str(other["read"]) == f"RuntimeError: process 0: {lead['read']}"
    assert str(lead["write"]) == "OSError: disk full"
    assert str(other["write"]) == "RuntimeError: process 0: OSError: disk full"
    assert not (out / "new.npz").exists()


def test_cli_in_two_processes_writes_one_image(tmp_path_factory):
    """``cli.main(argv, device="cpu")`` in a group of 2: both render their
    rows, process 0 alone writes out.log and the images, which hold the
    single-process (2, 1) frame."""
    from raytracing_course_2024_tpu_torch.runtime.image_io import read_png, read_ppm

    out = _scene_dir(tmp_path_factory, "cli")
    (out / "cli").mkdir()
    ranks = _run_world("cli", 2, out)
    assert [int(g["rc"]) for g in ranks] == [0, 0]
    assert sorted(p.name for p in (out / "cli").iterdir()) == ["out.log", "out.png", "out.ppm"]
    img = read_ppm(str(out / "cli" / "out.ppm"))
    np.testing.assert_array_equal(img, ranks[0]["ref"])
    np.testing.assert_array_equal(read_png(str(out / "cli" / "out.png")), img)
    lead, other = ((out / f"cli-{r}.log").read_text() for r in range(2))
    assert "Processes: 2, backend: gloo" in lead and "Rendering took" in lead
    assert "Rendering took" not in other


# --- the mesh layout, faked processes (no group) -------------------------


def _cpus(*ids):
    return [torch.device("cpu", i) for i in ids]


def test_multihost_mesh_layout():
    """2 processes x 4 devices (the JAX test's layout: process i % 2 owns
    device i): tile rows 0-1 on process 0, rows 2-3 on process 1, each row
    inside one process, process 0's devices its own."""
    from raytracing_course_2024_tpu_torch.parallel import make_multihost_mesh

    layout = [_cpus(0, 2, 4, 6), _cpus(1, 3, 5, 7)]
    mesh = make_multihost_mesh(4, 2, layout=layout)
    assert mesh.shape == {"tile": 4, "spp": 2}
    assert [[d.index for d in row] for row in mesh.devices] == [[0, 2], [4, 6], [1, 3], [5, 7]]
    assert mesh.ranks == ((0, 0), (0, 0), (1, 1), (1, 1))
    assert mesh.cells() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert mesh.distinct() == _cpus(0, 2, 4, 6)
    # fewer cells than devices: the first, process-major
    assert make_multihost_mesh(1, 2, layout=layout).ranks == ((0, 0),)
    assert make_multihost_mesh(3, 1, layout=[_cpus(0), _cpus(1), _cpus(2)]).ranks == (
        (0,), (1,), (2,))


@pytest.mark.parametrize("shape,layout", [
    ((3, 2), [_cpus(0, 1, 2), _cpus(3, 4, 5)]),   # row 1 = devices 2 and 3
    ((2, 2), [_cpus(0), _cpus(1, 2, 3)]),           # row 0 = devices 0 and 1
])
def test_multihost_mesh_refuses_a_row_across_processes(shape, layout):
    from raytracing_course_2024_tpu_torch.parallel import make_multihost_mesh

    with pytest.raises(ValueError, match="must divide each process's device count"):
        make_multihost_mesh(*shape, layout=layout)


def test_multihost_mesh_needs_enough_devices():
    from raytracing_course_2024_tpu_torch.parallel import make_multihost_mesh

    with pytest.raises(ValueError, match="needs 8 devices, have 6"):
        make_multihost_mesh(4, 2, layout=[_cpus(0, 1, 2), _cpus(3, 4, 5)])


@pytest.mark.parametrize("shape", [(4, 2), (8, 1), (2, 2)])
def test_multihost_mesh_of_one_process_is_make_mesh(shape):
    from raytracing_course_2024_tpu_torch.parallel import make_mesh, make_multihost_mesh

    devs = _cpus(*range(8))
    assert make_multihost_mesh(*shape, devices=devs) == make_mesh(*shape, devices=devs)
    assert make_multihost_mesh(*shape, layout=[devs]) == make_mesh(*shape, devices=devs)
    assert make_multihost_mesh(*shape, devices=devs).ranks is None


def test_frame_on_a_mesh_across_processes_needs_a_group():
    from raytracing_course_2024_tpu_torch.parallel import (make_multihost_mesh,
                                                           render_frame_sharded)
    from raytracing_course_2024_tpu_torch.runtime.render import ShardedRenderer
    from torch_parity import descs

    _, td = descs("mixed", W, H, 2)
    sr = ShardedRenderer(td, mesh=make_multihost_mesh(1, 1, devices=["cpu"]))
    mesh = make_multihost_mesh(2, 1, layout=[_cpus(0), _cpus(1)])
    with pytest.raises(ValueError, match="no process group"):
        render_frame_sharded(SEED, sr.scenes, sr.cfg, sr.cam, W, H, 2, mesh)


# --- init_distributed: the defaults and the backend rule, stubbed -----------


@pytest.fixture
def launcher_env(monkeypatch):
    for k in LAUNCHER_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_init_distributed_without_a_launcher_is_a_no_op(launcher_env):
    from raytracing_course_2024_tpu_torch.parallel import init_distributed

    assert init_distributed() is False
    assert init_distributed(coordinator_address="localhost:1234") is False  # one process
    assert init_distributed(num_processes=4) is False  # no address
    launcher_env.setenv("WORLD_SIZE", "1")
    launcher_env.setenv("MASTER_ADDR", "localhost")
    assert init_distributed() is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("env,kw,cards,want", [
    # torch.distributed.run: two processes on a host of two cards -> NCCL
    ({"WORLD_SIZE": "2", "RANK": "1", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
      "MASTER_ADDR": "node0", "MASTER_PORT": "2345"}, {}, 2,
     ("nccl", "tcp://node0:2345", 2, 1, 1)),
    # two processes on one card -> gloo, no card made current
    ({"WORLD_SIZE": "2", "RANK": "0", "LOCAL_RANK": "0", "LOCAL_WORLD_SIZE": "2",
      "MASTER_ADDR": "node0", "MASTER_PORT": "2345"}, {}, 1,
     ("gloo", "tcp://node0:2345", 2, 0, None)),
    # explicit arguments, no launcher: every process taken to be local
    ({}, dict(coordinator_address="file:///tmp/store", num_processes=4, process_id=3), 0,
     ("gloo", "file:///tmp/store", 4, 3, None)),
    ({}, dict(coordinator_address="host:99", num_processes=2, process_id=1), 2,
     ("nccl", "tcp://host:99", 2, 1, 1)),
    # a backend asked for is used as asked
    ({"WORLD_SIZE": "2", "RANK": "0", "MASTER_ADDR": "a", "MASTER_PORT": "7"},
     dict(backend="gloo"), 4, ("gloo", "tcp://a:7", 2, 0, None)),
])
def test_init_distributed_picks_the_backend_from_the_layout(launcher_env, env, kw, cards,
                                                            want):
    from raytracing_course_2024_tpu_torch.parallel import shard

    for k, v in env.items():
        launcher_env.setenv(k, v)
    calls, current = [], []
    launcher_env.setattr(shard.dist, "init_process_group",
                         lambda backend, init_method, world_size, rank:
                         calls.append((backend, init_method, world_size, rank)))
    launcher_env.setattr(shard.torch.cuda, "device_count", lambda: cards)
    launcher_env.setattr(shard.torch.cuda, "set_device", current.append)
    assert shard.init_distributed(**kw) is True
    assert calls == [want[:4]]
    assert current == ([] if want[4] is None else [want[4]])


@pytest.mark.parametrize("local_rank,local_world,cards,want", [
    (0, 1, 4, [0, 1, 2, 3]), (1, 2, 4, [1, 3]), (1, 2, 1, [0]), (2, 4, 2, [0]),
    (3, 4, 4, [3]),
])
def test_local_cards_split_the_host_between_its_processes(monkeypatch, local_rank,
                                                          local_world, cards, want):
    from raytracing_course_2024_tpu_torch.parallel import shard

    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local_world))
    monkeypatch.setattr(shard, "_group_up", lambda: True)
    monkeypatch.setattr(shard.dist, "get_rank", lambda: local_rank)
    monkeypatch.setattr(shard.dist, "get_world_size", lambda: local_world)
    monkeypatch.setattr(shard.torch.cuda, "device_count", lambda: cards)
    assert shard.local_cards() == [torch.device("cuda", i) for i in want]


if __name__ == "__main__":
    _worker(sys.argv[1], Path(sys.argv[2]), sys.argv[3], int(sys.argv[4]), int(sys.argv[5]))

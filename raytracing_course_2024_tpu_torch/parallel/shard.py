"""Multi-device rendering over a (tile, spp) mesh of devices, in one
process or across processes (the JAX package's ``parallel/shard.py``).

* **tile**: image rows are split over the tile axis; the work is disjoint
  and the tiles are concatenated.
* **spp**: the devices of one tile render the same pixels at disjoint
  samples, and their mean images are averaged on the tile's first device
  in a fixed order (the JAX package's ``pmean``).

Each distinct device of the mesh gets a thread of its own, which runs that
device's shards in mesh order with the device made current when it is a
card, through the single-device engines and their global offsets
(``pix_base``, ``samp_base``, ``n_pix``). Every draw is keyed by the global
(seed, sample, pixel) through the counter RNG, so a sharded frame equals the
single-device frame up to the order of the sums, on every mesh and engine,
and a frame is deterministic. The JAX package's batch engine folds a key
per shard instead; here the batch engine is mesh-invariant too.

Across processes (``init_distributed``, then ``make_multihost_mesh``; one
process per host or per card, started by a launcher such as ``python -m
torch.distributed.run``), the tile axis spans the processes and the spp
axis stays inside each. A process renders only its own cells, at their
global tile and spp offsets, and takes each of its tiles' spp mean itself,
in mesh order. The tiles are then gathered in tile order (``all_gather``),
the path vertices summed (``all_reduce``, float64) and the rounds gathered
(``all_gather_object``), on the calling thread once the shard threads have
joined. Every process returns the same frame, equal bit for bit to the
frame of the same mesh in one process. Under NCCL the tiles stay on the
card; under gloo they travel as CPU tensors.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist

from ..integrator.path import DEFAULT_BATCH, TraceConfig, render_batches
from ..integrator.wavefront import render_wavefront, render_wavefront_sticky
from ..ops.camera import CameraArrays, pack_camera_row
from ..runtime.profiling import count, span

log = logging.getLogger("rt_torch")


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    """This process's rank in its process group; 0 without a group."""
    return dist.get_rank() if _group_up() else 0


def process_count() -> int:
    """The processes of the group; 1 without a group."""
    return dist.get_world_size() if _group_up() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (tile, spp) grid of torch devices: ``devices[tile][spp]``. The same
    device may appear more than once (several shards on one card).
    ``ranks[tile][spp]`` is the process that renders each cell
    (``make_multihost_mesh``); None means this process renders them all."""

    devices: tuple
    ranks: tuple | None = None
    axis_names = ("tile", "spp")

    @property
    def shape(self) -> dict:
        return {"tile": len(self.devices), "spp": len(self.devices[0])}

    def cells(self) -> list:
        """This process's cells, (tile, spp) in mesh order."""
        me = process_index()
        return [(ti, si) for ti, row in enumerate(self.devices) for si in range(len(row))
                if self.ranks is None or self.ranks[ti][si] == me]

    def distinct(self) -> list:
        """This process's devices, each once, in mesh order."""
        return list(dict.fromkeys(self.devices[ti][si] for ti, si in self.cells()))


def make_mesh(n_tiles: int, n_spp: int, devices=None) -> Mesh:
    """The first ``n_tiles * n_spp`` of ``devices`` (default: every CUDA
    device), tile-major. Raises when there are fewer."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    need = n_tiles * n_spp
    if n_tiles < 1 or n_spp < 1 or len(devices) < need:
        raise ValueError(f"a {n_tiles}x{n_spp} mesh needs {need} devices, have {len(devices)}")
    return Mesh(tuple(tuple(devices[t * n_spp:(t + 1) * n_spp]) for t in range(n_tiles)))


def _local_layout(rank: int, world: int) -> tuple:
    """(local rank, processes on this host) from the launcher's
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``; without them every process is
    taken to run on this host."""
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def init_distributed(coordinator_address: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None) -> bool:
    """Join the process group of a multi-process render (the JAX package's
    ``init_distributed``); call it once per process before rendering.

    The defaults come from the launcher's environment (``python -m
    torch.distributed.run`` sets ``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``), so
    a launcher only sets variables. ``coordinator_address`` is ``host:port``
    or an init URL (``tcp://...``, ``file://...``). Returns False, creating
    no group, without an address or with at most one process.

    ``backend=None`` takes ``"nccl"`` when each process of this host has a
    card of its own (``LOCAL_WORLD_SIZE <= torch.cuda.device_count()``) and
    ``"gloo"`` otherwise: NCCL refuses two processes on one card. The choice
    is made from that layout before anything runs, and logged. A given
    backend is used as asked. Under NCCL, card ``LOCAL_RANK`` is made
    current."""
    env = os.environ
    nproc = num_processes or int(env.get("WORLD_SIZE") or 0)
    addr = coordinator_address
    if addr is None and env.get("MASTER_ADDR"):
        addr = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if not addr or nproc <= 1:
        return False
    rank = int(env.get("RANK", "0")) if process_id is None else process_id
    local_rank, local_world = _local_layout(rank, nproc)
    if backend is None:
        cards = torch.cuda.device_count()
        backend = "nccl" if local_world <= cards else "gloo"
        log.info("init_distributed: backend %s (%d processes on this host, %d cards)",
                 backend, local_world, cards)
    if backend == "nccl":
        torch.cuda.set_device(local_rank)
    url = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=url, world_size=nproc, rank=rank)
    log.info("init_distributed: process %d of %d joined over %s", rank, nproc, backend)
    return True


def local_cards() -> list:
    """This process's cards: every card without a process group; in a group,
    local process r of L on a host of n cards takes cards r, r + L, ... (card
    r % n when n < L: processes then share a card)."""
    n = torch.cuda.device_count()
    if not _group_up() or n == 0:
        return [torch.device("cuda", i) for i in range(n)]
    local_rank, local_world = _local_layout(dist.get_rank(), dist.get_world_size())
    if n < local_world:
        return [torch.device("cuda", local_rank % n)]
    return [torch.device("cuda", i) for i in range(local_rank, n, local_world)]


def process_layout(devices) -> list:
    """Every process's device list, by rank: gathered with
    ``all_gather_object`` in a process group, else ``[devices]``."""
    devices = [torch.device(d) for d in devices]
    if not _group_up():
        return [devices]
    layout = [None] * dist.get_world_size()
    dist.all_gather_object(layout, devices)
    return layout


def make_multihost_mesh(n_tiles: int, n_spp: int, devices=None, layout=None) -> Mesh:
    """A mesh whose tile axis spans processes and whose spp axis stays inside
    a process (the JAX package's ``make_multihost_mesh``): each process owns
    whole tile rows, and only the finished tiles cross between processes.

    ``devices`` are this process's (default: ``local_cards()``); ``layout``
    is every process's device list by rank (default: ``process_layout``;
    tests pass one to fake processes). Cells are taken process-major, each
    process's devices in their order, the first ``n_tiles * n_spp``
    tile-major, as the JAX package's sort by (process_index, id) lays them.
    Raises ``ValueError`` when a tile row would span processes. With one
    process and no group it is ``make_mesh``."""
    if layout is None:
        layout = process_layout(local_cards() if devices is None else devices)
    if len(layout) == 1 and not _group_up():
        return make_mesh(n_tiles, n_spp, layout[0])
    flat = [(rank, torch.device(d)) for rank, devs in enumerate(layout) for d in devs]
    need = n_tiles * n_spp
    if n_tiles < 1 or n_spp < 1 or len(flat) < need:
        raise ValueError(f"a {n_tiles}x{n_spp} mesh needs {need} devices, have {len(flat)}")
    rows = [flat[t * n_spp:(t + 1) * n_spp] for t in range(n_tiles)]
    for t, row in enumerate(rows):
        procs = sorted({rank for rank, _ in row})
        if len(procs) > 1:
            raise ValueError(
                f"tile row {t} spans processes {procs}: n_spp={n_spp} must divide each "
                "process's device count, so that the spp mean stays inside a process")
    return Mesh(tuple(tuple(d for _, d in row) for row in rows),
                tuple(tuple(rank for rank, _ in row) for row in rows))


def render_frame_sharded(seed: int, scenes: dict, cfg: TraceConfig, cam: CameraArrays,
                         width: int, height: int, samples: int, mesh: Mesh,
                         engine: str = "batch", graphs: dict | None = None, frame=None):
    """Full-frame mean radiance of one seed over ``mesh``.

    ``scenes`` maps each of this process's devices of the mesh to the scene
    built there. Rows are split over the tile axis, ``ceil(height /
    n_tiles)`` each; the rows past the last re-render the last row (the
    camera always sees the true height) and are cropped. Samples are split
    over the spp axis (``samples % n_spp == 0``). A shard runs ``engine`` on
    ``DEFAULT_BATCH`` lanes at most, as a ``Renderer`` does. Returns ((3,
    height, width) channel-major radiance on the mesh's first device (on a
    mesh across processes: this process's first), path vertices of all
    shards (the padded rows' included), the rounds of each shard as
    ``[tile][spp]``: 0 on the batch engine). On a mesh across processes,
    every process of the group must call it, and each returns the same.
    ``graphs`` maps devices to the graph caches of their scenes
    (``runtime/graphs.py``): every shard on a device replays that cache's
    graphs, its ``pix_base`` and ``samp_base`` being values on the device.
    Spans: ``rt.shard`` for each shard on its thread (``frame``, the
    renderer's frame number, in its args), ``rt.shard.combine`` for the
    gather of the tiles (``_combine`` across processes); each shard adds
    its path vertices to the counter ``rt.path_vertices``."""
    if engine not in ("batch", "wavefront", "sticky"):
        raise ValueError(f"unknown engine {engine!r}")
    n_tiles, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    if samples % n_spp:
        raise ValueError(f"{samples} samples do not split over {n_spp} spp shards")
    if mesh.ranks is not None and not _group_up():
        raise ValueError("the mesh spans processes, but no process group is up "
                         "(init_distributed)")
    rows_per = -(-height // n_tiles)  # ceil: pad rows, never the camera
    spp_per = samples // n_spp
    n_pix = rows_per * width
    seed32 = (seed * 2654435761) & 0xFFFFFFFF

    def shard(ti: int, si: int):
        dev = mesh.devices[ti][si]
        cache = (graphs or {}).get(dev)
        pix_base, samp_base = ti * n_pix, si * spp_per
        on = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with on, span("rt.shard", frame):
            if engine == "batch":
                cam_row = torch.from_numpy(pack_camera_row(cam)[0]).to(dev)
                outs, verts = render_batches(scenes[dev], seed32, cam_row, cfg, width, height,
                                             spp_per, DEFAULT_BATCH, pix_base, n_pix, samp_base,
                                             graphs=cache)
                out = torch.cat(outs, dim=1)[:, :n_pix], float(verts), 0
            else:
                render = render_wavefront_sticky if engine == "sticky" else render_wavefront
                out = render(seed32, pix_base, samp_base, cam, scenes[dev], cfg, width, height,
                             n_pix, spp_per, min(DEFAULT_BATCH, n_pix * spp_per), graphs=cache)
            count("rt.path_vertices", out[1])  # this process's shards, as rt.lane_slots
            return out

    # one thread per distinct device, running its shards in mesh order: the
    # shards of one device share its stream, and threads that take turns at
    # the interpreter lock between many small launches slow each other down
    mine = mesh.cells()
    work = {}
    for ti, si in mine:
        work.setdefault(mesh.devices[ti][si], []).append((ti, si))
    with ThreadPoolExecutor(max_workers=max(len(work), 1)) as pool:
        futures = [pool.submit(lambda cells: [(c, shard(*c)) for c in cells], cells)
                   for cells in work.values()]
        done = dict(pair for f in futures for pair in f.result())
    with span("rt.shard.combine", frame):
        tiles = {}
        for ti in dict.fromkeys(ti for ti, _ in mine):
            tile_dev = mesh.devices[ti][0]
            acc = done[(ti, 0)][0].to(tile_dev)
            for si in range(1, n_spp):  # the spp mean, in mesh order
                acc = acc + done[(ti, si)][0].to(tile_dev)
            tiles[ti] = (acc / n_spp).reshape(3, rows_per, width)
        verts = sum(done[c][1] for c in mine)
        rounds = {c: done[c][2] for c in mine}
        if mesh.ranks is None:
            home = mesh.devices[0][0]
            img = torch.cat([tiles[ti].to(home) for ti in range(n_tiles)], dim=1)
        else:
            img, verts, rounds = _combine(tiles, verts, rounds, mesh, rows_per, width)
    rounds = [[rounds[(ti, si)] for si in range(n_spp)] for ti in range(n_tiles)]
    return img[:, :height], verts, rounds


def _combine(tiles: dict, verts: float, rounds: dict, mesh: Mesh, rows_per: int, width: int):
    """Every process's tiles, path vertices and rounds, on every process:
    (3, n_tiles * rows_per, width) frame, path vertices, {(tile, spp): rounds}."""
    world, me = dist.get_world_size(), dist.get_rank()
    comm = (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))
    owned = [[ti for ti, ranks in enumerate(mesh.ranks) if ranks[0] == r] for r in range(world)]
    buf = torch.zeros((max(map(len, owned)), 3, rows_per, width), dtype=torch.float32,
                      device=comm)
    for j, ti in enumerate(owned[me]):
        buf[j] = tiles[ti]
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf)
    total = torch.tensor(verts, dtype=torch.float64, device=comm)
    dist.all_reduce(total)
    each = [None] * world
    dist.all_gather_object(each, rounds)
    mine = mesh.cells()
    home = mesh.devices[mine[0][0]][mine[0][1]] if mine else comm
    img = torch.cat([parts[mesh.ranks[ti][0]][owned[mesh.ranks[ti][0]].index(ti)]
                     for ti in range(len(mesh.ranks))], dim=1).to(home)
    return img, float(total), {c: n for part in each for c, n in part.items()}

"""Multi-device rendering in one process over a (tile, spp) mesh of devices
(the JAX package's ``parallel/shard.py``).

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
"""

from __future__ import annotations

import contextlib
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import torch

from ..integrator.path import DEFAULT_BATCH, TraceConfig, render_batches
from ..integrator.wavefront import render_wavefront, render_wavefront_sticky
from ..ops.camera import CameraArrays, pack_camera_row


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (tile, spp) grid of torch devices: ``devices[tile][spp]``. The same
    device may appear more than once (several shards on one card)."""

    devices: tuple
    axis_names = ("tile", "spp")

    @property
    def shape(self) -> dict:
        return {"tile": len(self.devices), "spp": len(self.devices[0])}

    def distinct(self) -> list:
        """The mesh's devices, each once, in mesh order."""
        return list(dict.fromkeys(d for row in self.devices for d in row))


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


def render_frame_sharded(seed: int, scenes: dict, cfg: TraceConfig, cam: CameraArrays,
                         width: int, height: int, samples: int, mesh: Mesh,
                         engine: str = "batch"):
    """Full-frame mean radiance of one seed over ``mesh``.

    ``scenes`` maps each device of the mesh to the scene built there.
    Rows are split over the tile axis, ``ceil(height / n_tiles)`` each; the
    rows past the last re-render the last row (the camera always sees the
    true height) and are cropped. Samples are split over the spp axis
    (``samples % n_spp == 0``). A shard runs ``engine`` on ``DEFAULT_BATCH``
    lanes at most, as a ``Renderer`` does. Returns ((3, height, width) channel-major radiance on the
    mesh's first device, path vertices of all shards (the padded rows'
    included), the rounds of each shard as ``[tile][spp]``: 0 on the batch
    engine)."""
    if engine not in ("batch", "wavefront", "sticky"):
        raise ValueError(f"unknown engine {engine!r}")
    n_tiles, n_spp = mesh.shape["tile"], mesh.shape["spp"]
    if samples % n_spp:
        raise ValueError(f"{samples} samples do not split over {n_spp} spp shards")
    rows_per = -(-height // n_tiles)  # ceil: pad rows, never the camera
    spp_per = samples // n_spp
    n_pix = rows_per * width
    seed32 = (seed * 2654435761) & 0xFFFFFFFF

    def shard(ti: int, si: int):
        dev = mesh.devices[ti][si]
        pix_base, samp_base = ti * n_pix, si * spp_per
        on = torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
        with on:
            if engine == "batch":
                cam_row = torch.from_numpy(pack_camera_row(cam)[0]).to(dev)
                outs, verts = render_batches(scenes[dev], seed32, cam_row, cfg, width, height,
                                             spp_per, DEFAULT_BATCH, pix_base, n_pix, samp_base)
                return torch.cat(outs, dim=1)[:, :n_pix], float(verts), 0
            render = render_wavefront_sticky if engine == "sticky" else render_wavefront
            return render(seed32, pix_base, samp_base, cam, scenes[dev], cfg, width, height,
                          n_pix, spp_per, min(DEFAULT_BATCH, n_pix * spp_per))

    # one thread per distinct device, running its shards in mesh order: the
    # shards of one device share its stream, and threads that take turns at
    # the interpreter lock between many small launches slow each other down
    work = {dev: [] for dev in mesh.distinct()}
    for ti in range(n_tiles):
        for si in range(n_spp):
            work[mesh.devices[ti][si]].append((ti, si))
    with ThreadPoolExecutor(max_workers=len(work)) as pool:
        futures = [pool.submit(lambda cells: [(c, shard(*c)) for c in cells], cells)
                   for cells in work.values()]
        done = dict(pair for f in futures for pair in f.result())
    results = [[done[(ti, si)] for si in range(n_spp)] for ti in range(n_tiles)]
    home = mesh.devices[0][0]
    tiles = []
    for ti, row in enumerate(results):
        tile_dev = mesh.devices[ti][0]
        acc = row[0][0].to(tile_dev)
        for img, _, _ in row[1:]:  # the spp mean, in mesh order
            acc = acc + img.to(tile_dev)
        tiles.append((acc / n_spp).reshape(3, rows_per, width).to(home))
    verts = sum(r[1] for row in results for r in row)
    rounds = [[r[2] for r in row] for row in results]
    return torch.cat(tiles, dim=1)[:, :height], verts, rounds

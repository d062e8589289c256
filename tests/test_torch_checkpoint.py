"""PyTorch port, checkpointed resume (``runtime/checkpoint.py``) on the CPU:
a resumed frame equals the uninterrupted one bit for bit on all three
engines; a checkpoint of another scene, camera, engine or backend raises;
one of another shape, seed or chunk size starts over; the file is the JAX
package's. Against the JAX package's ``render_with_checkpoints``: the lane
engines image for image (>= 99 % of pixels within 1e-4, path vertices
within 1 %, as tests/test_torch_wavefront.py holds whole frames), the batch
engine within 3 sigma of the frame mean (its JAX twin draws threefry
numbers on the CPU, as in tests/test_torch_render.py)."""

import logging
import os

import numpy as np
import pytest

from raytracing_course_2024_tpu.runtime.checkpoint import (
    render_with_checkpoints as j_render_with_checkpoints,
)
from raytracing_course_2024_tpu.runtime.render import Renderer as JRenderer
from raytracing_course_2024_tpu_torch.runtime.checkpoint import (
    render_with_checkpoints,
    scene_fingerprint,
)
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from torch_parity import descs

SEED = 3
ENGINES = ("batch", "wavefront", "sticky")
JAX_KEYS = {"sum", "done_spp", "next_chunk", "shape", "seed", "chunk_spp", "scene"}


class Interrupted(RuntimeError):
    pass


class Chunks:
    """A renderer as ``render_with_checkpoints`` sees it: counts the chunks
    it renders (with ``stats``, their path vertices too) and raises
    ``Interrupted`` instead of rendering chunk ``stop`` (counted from 0)."""

    def __init__(self, renderer, stop=None, stats=False):
        self.r, self.stop, self.stats, self.calls, self.verts = renderer, stop, stats, 0, 0.0

    def __getattr__(self, name):
        return getattr(self.r, name)

    def render_radiance(self, seed, samples):
        if self.calls == self.stop:
            raise Interrupted(f"chunk {self.calls}")
        self.calls += 1
        if not self.stats:
            return self.r.render_radiance(seed=seed, samples=samples)
        img, stats = self.r.render_radiance(seed=seed, samples=samples, with_stats=True)
        self.verts += stats.path_vertices
        return img


def resume_is_bit_exact(r, tmp_path, total_spp, chunk_spp, stop):
    """Renders ``total_spp`` uninterrupted, then again with an interruption
    before chunk ``stop`` and a resume; asserts the two equal bit for bit
    and returns the frame."""
    full = render_with_checkpoints(r, str(tmp_path / "full.npz"), total_spp, chunk_spp, SEED)
    ck = str(tmp_path / "cut.npz")
    with pytest.raises(Interrupted):
        render_with_checkpoints(Chunks(r, stop=stop), ck, total_spp, chunk_spp, SEED)
    with np.load(ck) as c:
        assert int(c["done_spp"]) == stop * chunk_spp and int(c["next_chunk"]) == stop
    rest = Chunks(r)
    resumed = render_with_checkpoints(rest, ck, total_spp, chunk_spp, SEED)
    assert rest.calls == -(-total_spp // chunk_spp) - stop
    assert np.array_equal(resumed, full), np.abs(resumed - full).max()
    assert sorted(os.listdir(tmp_path)) == ["cut.npz", "full.npz"]  # no .tmp.npz left
    return full


def _renderer(engine="batch", name="mixed", **kw):
    _, td = descs(name, 16, 12, 8)
    return Renderer(td, device="cpu", engine=engine, **kw)


@pytest.mark.parametrize("engine", ENGINES)
def test_resume_after_interruption_is_bit_exact(engine, tmp_path):
    """8 spp in 2-spp chunks, interrupted before chunk 2, resumed."""
    full = resume_is_bit_exact(_renderer(engine), tmp_path, 8, 2, stop=2)
    assert full.shape == (12, 16, 3) and np.isfinite(full).all() and full.max() > 0


def _other(what):
    """The base renderer (MIXED, batch, dense) with one thing changed."""
    if what == "scene":
        return _renderer(name="fallback")
    if what == "engine":
        return _renderer("sticky")
    if what == "backend":
        return _renderer(backend="bvh")
    _, td = descs("mixed", 16, 12, 8)
    if what == "camera":
        td.settings.camera.position = tuple(np.add(td.settings.camera.position, (0, 0, 0.5)))
    elif what == "depth":
        td.settings.ray_depth += 1
    return Renderer(td, device="cpu")


@pytest.mark.parametrize("what", ["scene", "camera", "engine", "backend", "depth"])
def test_checkpoint_of_another_configuration_raises(what, tmp_path):
    base = _renderer()
    ck = str(tmp_path / "state.npz")
    render_with_checkpoints(base, ck, total_spp=2, chunk_spp=2, seed=SEED)
    other = _other(what)
    assert scene_fingerprint(other) != scene_fingerprint(base)
    with pytest.raises(ValueError, match="different scene"):
        render_with_checkpoints(other, ck, total_spp=4, chunk_spp=2, seed=SEED)
    # the same configuration still resumes (a no-op completion)
    assert np.isfinite(render_with_checkpoints(base, ck, 2, 2, SEED)).all()


def test_fingerprint_is_stable():
    """Two builds of one configuration hash alike; a BVH's arrays are hashed."""
    assert scene_fingerprint(_renderer()) == scene_fingerprint(_renderer())
    bvh = _renderer(backend="bvh")
    assert bvh.arrays.bvh is not None
    assert scene_fingerprint(bvh) == scene_fingerprint(_renderer(backend="bvh"))


@pytest.mark.parametrize("change", ["shape", "seed", "chunk"])
def test_incompatible_checkpoint_starts_over(change, tmp_path, caplog):
    """A checkpoint of this scene at another shape (its stored shape
    rewritten), seed or chunk size is ignored with a warning: the frame
    equals a fresh render with the new parameters."""
    r = _renderer()
    ck = str(tmp_path / "state.npz")
    render_with_checkpoints(r, ck, total_spp=4, chunk_spp=2, seed=SEED)
    seed, chunk = SEED, 2
    if change == "shape":
        with np.load(ck) as c:
            fields = dict(c)
        fields["shape"] = np.array([13, 16, 3])
        np.savez(ck, **fields)
    elif change == "seed":
        seed = SEED + 1
    else:
        chunk = 1
    with caplog.at_level(logging.WARNING, logger="rt_torch"):
        got = render_with_checkpoints(r, ck, total_spp=4, chunk_spp=chunk, seed=seed)
    assert any("starting over" in m for m in caplog.messages), caplog.messages
    fresh = render_with_checkpoints(r, str(tmp_path / "fresh.npz"), 4, chunk, seed)
    assert np.array_equal(got, fresh)
    with np.load(ck) as c:
        assert int(c["seed"]) == seed and int(c["chunk_spp"]) == chunk
        assert int(c["done_spp"]) == 4 and tuple(c["shape"]) == (12, 16, 3)


def _jax_and_port(jr, r, tmp_path, total_spp, chunk_spp):
    """Both packages' ``render_with_checkpoints`` on the same frame; the
    two files have the same keys and types."""
    jc, tc = Chunks(jr, stats=True), Chunks(r, stats=True)
    want = j_render_with_checkpoints(jc, str(tmp_path / "jax.npz"), total_spp, chunk_spp, SEED)
    got = render_with_checkpoints(tc, str(tmp_path / "port.npz"), total_spp, chunk_spp, SEED)
    assert sorted(os.listdir(tmp_path)) == ["jax.npz", "port.npz"]
    with np.load(tmp_path / "jax.npz") as j, np.load(tmp_path / "port.npz") as t:
        assert set(j.files) == set(t.files) == JAX_KEYS
        for k in JAX_KEYS - {"scene"}:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
            if k != "sum":
                assert np.array_equal(j[k], t[k]), k
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    return got, want, tc.verts, jc.verts


@pytest.mark.parametrize("engine", ["wavefront", "sticky"])
def test_lane_engines_agree_with_jax_checkpointed(engine, tmp_path):
    """MIXED 24x18, 4 spp in 2-spp chunks: the lane engines draw the JAX
    package's counter streams, so the checkpointed frames agree image for
    image. Each chunk flips about one path of the frame's 432 pixels (a
    grazing accept or Fresnel decision: 1 pixel in each of this run's two
    chunks), and the flips of the chunks add up in the sum."""
    jd, td = descs("mixed", 24, 18, 4)
    jr = JRenderer(jd, engine=engine)
    # the XLA dense sweep in place of the interpret-mode triangle kernel
    jr.arrays = jr.arrays._replace(tri_pack=None)
    got, want, verts, jverts = _jax_and_port(jr, Renderer(td, device="cpu", engine=engine),
                                             tmp_path, 4, 2)
    assert np.isfinite(got).all() and got.max() > 0
    ok = (np.abs(got - np.asarray(want)) <= 1e-4).all(axis=-1)
    assert ok.mean() >= 0.99, ok.mean()
    assert abs(verts - jverts) <= 0.01 * jverts, (verts, jverts)


def test_batch_engine_agrees_with_jax_checkpointed(tmp_path):
    """MIXED 24x18, 8 spp in 4-spp chunks: per-channel frame means within 3
    sigma, sigma the standard error of an 8-spp frame mean from the port's
    per-pixel variance over 8 one-sample frames, times sqrt(2) for the
    difference of two independent estimates."""
    w, h, spp = 24, 18, 8
    jd, td = descs("mixed", w, h, spp)
    r = Renderer(td, device="cpu")
    got, want, _, _ = _jax_and_port(JRenderer(jd), r, tmp_path, spp, 4)
    singles = np.stack([r.render_radiance(seed=100 + s, samples=1) for s in range(8)])
    var = singles.var(axis=0, ddof=1)
    sigma = np.sqrt(var.sum(axis=(0, 1)) / spp) / (w * h)
    diff = np.abs(got.mean(axis=(0, 1)) - np.asarray(want).mean(axis=(0, 1)))
    assert (sigma > 0).all()
    assert (diff < 3.0 * np.sqrt(2.0) * sigma).all(), (diff, sigma)

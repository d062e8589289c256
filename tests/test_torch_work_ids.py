"""PyTorch port, the 32-bit work-id limit (``ops/rng.py:check_work_ids``).

Every engine keys a (pixel, sample) item's draws by ``work_key(seed,
sample * frame_pix + pixel)`` in 32 bits, so past 2^32 work items of one
seed two items would draw the same numbers. A render that would pass the
limit raises ``ValueError`` naming ``render_with_checkpoints`` (whose
chunks reseed) before any work, on the batch, counter-wavefront and sticky
engines; a frame at the limit renders. 1280x720 reaches it at 4,660 spp.
The engines are driven on a 4x4 frame with a large ``samp_base``, so
nothing renders at full size.
"""

import pytest
import torch

from raytracing_course_2024_tpu_torch.integrator import path as P
from raytracing_course_2024_tpu_torch.integrator import wavefront as W
from raytracing_course_2024_tpu_torch.ops import rng
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from torch_parity import descs

W_, H_ = 4, 4
AT_LIMIT = 2**32 // (W_ * H_) - 2  # samp_base: 2 more samples end at the 2^32nd work item


def test_limit_at_1280x720():
    rng.check_work_ids(1280 * 720, 0, 4660)
    rng.check_work_ids(1280 * 720, 4659, 1)
    for samp_base, samples in ((0, 4661), (4660, 1), (4000, 661)):
        with pytest.raises(ValueError, match="render_with_checkpoints"):
            rng.check_work_ids(1280 * 720, samp_base, samples)


@pytest.fixture
def no_work(monkeypatch):
    """Every entry into an engine's work raises."""

    def started(*a, **k):
        raise AssertionError("work started")

    for mod, name in ((P, "render_pixels"), (W, "_make_bounce_core"),
                      (W, "wavefront_loop"), (W, "FusedStickyLoop"), (W, "StickyLoop")):
        monkeypatch.setattr(mod, name, started)


def _renderer(engine, **kw):
    _, td = descs("mixed", W_, H_, 2)
    return Renderer(td, device="cpu", engine=engine, **kw)


def _render(r, samp_base, samples):
    seed32 = 12345
    if r.engine == "batch":
        outs, verts = P.render_batches(r.scene, seed32, r.cam_row, r.cfg, W_, H_, samples,
                                       r.batch_size, samp_base=samp_base)
        return torch.cat(outs, dim=1), float(verts)
    render = W.render_wavefront_sticky if r.engine == "sticky" else W.render_wavefront
    img, verts, _ = render(seed32, 0, samp_base, r.cam, r.scene, r.cfg, W_, H_, W_ * H_,
                           samples, min(r.batch_size, W_ * H_ * samples))
    return img, verts


ENGINES = {"batch": {}, "wavefront": {}, "sticky": {}, "sticky-lanes-below-pixels":
           dict(batch_size=8), "batch-modular": dict(russian_roulette=True)}


@pytest.mark.parametrize("case", list(ENGINES))
def test_engines_refuse_past_the_limit_before_any_work(case, no_work):
    r = _renderer(case.split("-")[0], **ENGINES[case])
    with pytest.raises(ValueError, match="render_with_checkpoints"):
        _render(r, AT_LIMIT, 3)
    with pytest.raises(ValueError, match="2\\^32"):
        _render(r, 0, 2**28 + 1)
    with pytest.raises(ValueError, match="render_with_checkpoints"):
        r.render_frame_device(seed=1, samples=2**28 + 1)  # 16 pixels x 2^28 samples = 2^32


@pytest.mark.parametrize("case", list(ENGINES))
def test_engines_render_at_the_limit(case):
    """The last two samples below 2^32 work items render, finite and lit;
    their work ids pass 2^31, so the int32 lanes hold them wrapped."""
    r = _renderer(case.split("-")[0], **ENGINES[case])
    img, verts = _render(r, AT_LIMIT, 2)
    assert tuple(img.shape) == (3, W_ * H_) and torch.isfinite(img).all() and img.max() > 0
    assert verts >= W_ * H_ * 2

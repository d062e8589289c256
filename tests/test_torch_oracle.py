"""PyTorch port against the independent f64 oracle (``tests/oracle_tracer.py``),
whole image, on the CPU: the JAX package's ``test_oracle_mini_scene_all_materials``
with the port's ``Renderer`` in its place.

The port renders with ``faithful=True`` (the reference's exact acceptance,
which the oracle implements, and with it the reference's 1/P(accept)
inflation, so this test pins that for the port too) and ``max_tries=16``,
so that the bounded rejection's kill path (< 1e-10) cannot bias the
comparison; on the batch engine, whose counter draws take 16 tries. The
thresholds are the JAX test's: z-scores against the oracle's own per-pixel
variance, median |z| < 1.6, more than 97 % of 4x4 blocks with |z| < 8,
channel means within 6 sigma + 5e-3.
"""

import numpy as np

import raytracing_course_2024_tpu.scene as jscene
import raytracing_course_2024_tpu_torch.scene as tscene
from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from oracle_tracer import Oracle
from test_oracle_parity import MINI_SCENE

ORACLE_SPP, PORT_SPP = 48, 512


def test_port_matches_the_f64_oracle_on_all_materials():
    """Plane, box, ellipsoid; diffuse, mirror, dielectric; a box light
    sampled by MIS (the JAX test's scene)."""
    o_img, o_var = Oracle(jscene.parse_text_scene(MINI_SCENE), seed=123).render(spp=ORACLE_SPP)
    r = Renderer(tscene.parse_text_scene(MINI_SCENE), device="cpu", faithful=True,
                 max_tries=16, engine="batch")
    assert not r.fused
    p_img = r.render_radiance(seed=0, samples=PORT_SPP)
    assert p_img.shape == o_img.shape and np.isfinite(p_img).all()

    sigma2 = o_var / ORACLE_SPP + o_var / PORT_SPP
    z = (p_img - o_img) / np.sqrt(np.maximum(sigma2, 1e-8))
    med = np.median(np.abs(z))
    assert med < 1.6, med
    # a low-spp oracle pixel that missed a rare bright path underestimates
    # its own variance: 4x4 blocks dilute such fireflies, not structured errors
    h, w, _ = o_img.shape
    bh, bw = h // 4, w // 4

    def blocks(a):
        return a[: bh * 4, : bw * 4].reshape(bh, 4, bw, 4, 3).mean(axis=(1, 3))

    bz = (blocks(p_img) - blocks(o_img)) / np.sqrt(np.maximum(blocks(sigma2) / 16.0, 1e-8))
    assert (np.abs(bz) < 8.0).mean() > 0.97, np.abs(bz).max()
    mean_sigma = np.sqrt(sigma2.sum(axis=(0, 1))) / (h * w)
    mean_diff = np.abs(p_img.mean(axis=(0, 1)) - o_img.mean(axis=(0, 1)))
    assert (mean_diff < 6.0 * mean_sigma + 5e-3).all(), (mean_diff, mean_sigma)

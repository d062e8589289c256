"""PyTorch port, the degenerate scenes of tests/test_edge_cases.py on the
CPU, on each engine, asserting what those tests assert of the JAX package:
an empty scene, a single ellipsoid, an emitter at depth 1, a mirror box at
depth 16, a lone emitter, and a 13x7 frame at depths 1, 2 and 7. The single
ellipsoid and the lone emitter also render with the BVH backend asked for
(a tree of one leaf, and a light table of one entry that the walk must find
as well); a scene without finite primitives refuses that backend.
"""

import numpy as np
import pytest

from raytracing_course_2024_tpu_torch.runtime.render import Renderer
from raytracing_course_2024_tpu_torch.scene import parse_text_scene
from test_edge_cases import HEADER

ENGINES = ["batch", "wavefront", "sticky"]


def _render(scene: str, engine: str, **kw) -> np.ndarray:
    r = Renderer(parse_text_scene(scene), device="cpu", engine=engine, **kw)
    rad = r.render_radiance()
    assert np.isfinite(rad).all()
    return rad


@pytest.mark.parametrize("engine", ENGINES)
def test_empty_scene_is_background(engine):
    rad = _render(HEADER.format(depth=3), engine)
    np.testing.assert_allclose(rad, np.broadcast_to((0.25, 0.5, 0.75), rad.shape), atol=1e-6)


SINGLE = HEADER.format(depth=2) + """
NEW_PRIMITIVE
ELLIPSOID 1 1 1
POSITION 0 0 0
COLOR 0.9 0.1 0.1
"""


@pytest.mark.parametrize("backend", ["dense", "bvh"])
@pytest.mark.parametrize("engine", ENGINES)
def test_single_primitive(engine, backend):
    rad = _render(SINGLE, engine, backend=backend)
    # background at the corner; the red diffuse sphere (lit by the bg via
    # one bounce) in the middle: red dominates blue there
    assert rad[0, 0, 2] > 0.7
    assert rad[6, 8, 0] > 2.0 * rad[6, 8, 2]
    assert rad[6, 8, 2] < 0.2


@pytest.mark.parametrize("engine", ENGINES)
def test_depth_one_only_emission(engine):
    scene = HEADER.format(depth=1) + """
NEW_PRIMITIVE
BOX 1 1 1
POSITION 0 0 0
COLOR 1 1 1
EMISSION 2 3 4
"""
    rad = _render(scene, engine)
    np.testing.assert_allclose(rad[6, 8], [2, 3, 4], atol=1e-5)


@pytest.mark.parametrize("engine", ENGINES)
def test_deep_recursion_mirror_box(engine):
    """Depth 16 inside a mirror box with no light: exactly 0, no NaN."""
    scene = """
DIMENSIONS 8 8
RAY_DEPTH 16
SAMPLES 2
BG_COLOR 0 0 0
CAMERA_POSITION 0 0 0
CAMERA_RIGHT 1 0 0
CAMERA_UP 0 1 0
CAMERA_FORWARD 0 0 -1
CAMERA_FOV_X 1.0
NEW_PRIMITIVE
BOX 3 3 3
POSITION 0 0 0
COLOR 0.9 0.9 0.9
METALLIC
"""
    rad = _render(scene, engine)
    np.testing.assert_allclose(rad, 0.0, atol=1e-6)


LIGHT_ONLY = HEADER.format(depth=4) + """
NEW_PRIMITIVE
ELLIPSOID 0.5 0.5 0.5
POSITION 0 0 0
EMISSION 7 7 7
"""


@pytest.mark.parametrize("backend", ["dense", "bvh"])
@pytest.mark.parametrize("engine", ENGINES)
def test_light_only_scene(engine, backend):
    rad = _render(LIGHT_ONLY, engine, backend=backend)
    assert abs(rad[6, 8, 0] - 7.0) < 1e-4  # direct view of the emitter


@pytest.mark.parametrize("planes", [0, 1])
def test_bvh_backend_refuses_a_scene_without_finite_primitives(planes):
    scene = HEADER.format(depth=2) + """
NEW_PRIMITIVE
PLANE 0 1 0
POSITION 0 -1 0
COLOR 0.5 0.5 0.5
""" * planes
    with pytest.raises(ValueError, match="at least one finite primitive"):
        Renderer(parse_text_scene(scene), device="cpu", backend="bvh")


@pytest.mark.parametrize("depth", [1, 2, 7])
@pytest.mark.parametrize("engine", ENGINES)
def test_odd_depths_and_sizes(engine, depth):
    """A frame that is no multiple of any lane block, at odd depths."""
    scene = HEADER.format(depth=depth).replace("DIMENSIONS 16 12", "DIMENSIONS 13 7") + """
NEW_PRIMITIVE
TRIANGLE -1 -1 0  1 -1 0  0 1 0
COLOR 0.5 0.5 0.5
"""
    rad = _render(scene, engine)
    assert rad.shape == (7, 13, 3)

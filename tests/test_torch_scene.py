"""PyTorch port, host scene layer: the port's numpy build, geo table and
camera row must equal the JAX package's exactly, scene_from_jax must
reproduce the port's own fused and modular device scenes, and the image writers must write the same
bytes."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracing_course_2024_tpu.ops.camera import camera_arrays as j_camera_arrays
from raytracing_course_2024_tpu.ops.pallas_bounce import build_geo_rows as j_geo_rows
from raytracing_course_2024_tpu.ops.pallas_bounce import pack_camera_row as j_cam_row
from raytracing_course_2024_tpu.runtime import image_io as j_io
from raytracing_course_2024_tpu_torch.ops.bounce import bounce_scene, build_geo_rows
from raytracing_course_2024_tpu_torch.ops.camera import camera_arrays, pack_camera_row
from raytracing_course_2024_tpu_torch.runtime import image_io as t_io
from raytracing_course_2024_tpu_torch.ops.scene_intersect import modular_scene
from raytracing_course_2024_tpu.scene import build_scene_arrays as j_build
from meshes import icosphere, mesh_scene_desc
from torch_parity import REPO, SCENES, builds, scene_from_jax, to_jnp


def _same(a, b):
    if a is None or b is None:
        return a is None and b is None
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("name", SCENES)
def test_build_matches_jax(name):
    (_, ja, js), (_, ta, ts) = builds(name)
    assert ts._asdict() == js._asdict()  # incl. mega_spec, light types
    assert ts.mega_spec
    for field in ja._fields:
        assert _same(getattr(ta, field), getattr(ja, field)), field


@pytest.mark.parametrize("name", SCENES)
def test_geo_rows_and_camera_row_match(name):
    (jd, ja, js), (td, ta, ts) = builds(name)
    assert _same(build_geo_rows(ta, ts), np.asarray(j_geo_rows(to_jnp(ja), js)))
    want = np.asarray(j_cam_row(j_camera_arrays(jd.settings.camera)))
    assert _same(pack_camera_row(camera_arrays(td.settings.camera)), want)


@pytest.mark.parametrize("name", SCENES)
def test_scene_from_jax_matches_port_build(name):
    (_, ja, js), (_, ta, ts) = builds(name)
    got, mod, statics = scene_from_jax(ja, js, "cpu")
    own = bounce_scene(ta, ts, "cpu")
    assert statics == ts
    for field in ("geo", "rec", "lp", "lspec"):
        assert torch.equal(getattr(got, field), getattr(own, field)), field
    assert np.array_equal(got.geo_np, own.geo_np)
    assert np.array_equal(got.lp_np, own.lp_np)
    own_mod = modular_scene(ta, ts, "cpu")
    assert mod.statics == ts
    for field in ("packed", "plane_packed", "pl_mask", "light_packed", "lspec", "tri_pack"):
        a, b = getattr(mod, field), getattr(own_mod, field)
        assert (a is None and b is None) or torch.equal(a, b), field
    assert torch.equal(mod.lspec, own.lspec)


def test_scene_from_jax_off_the_fused_gate():
    """A 320-triangle mesh has no fused scene, only the modular one."""
    verts, faces = icosphere(2)
    d = mesh_scene_desc(verts, faces)
    ja, js = j_build(d)
    fused, mod, statics = scene_from_jax(ja, js, "cpu")
    assert fused is None and mod.tri_pack is None and mod.packed.shape[1] == 321
    assert statics.num_prims == 321


def test_cornell_fixture_is_the_headline_family():
    """36 triangles: 5 walls (10), an emissive ceiling quad (2), two boxes
    (24); glTF metallic-roughness materials; no .bin needed."""
    (_, _, js), (td, ta, ts) = builds("cornell")
    assert ts.num_prims == 36 and ts.num_planes == 0 and ts.num_lights == 2
    assert {m for _, _, m in ts.mega_spec} == {3}  # PBR
    assert not ts.any_delta and not ts.any_nontri
    metallic = sorted(set(np.round(ta.metallic, 3)))
    assert metallic[0] == 0.0 and metallic[-1] > 0.5  # diffuse and metal walls
    text = open(os.path.join(REPO, "scenes", "cornell_box.gltf")).read()
    assert "data:application/octet-stream;base64," in text and ".bin" not in text


@pytest.mark.parametrize("seed", [0, 1])
def test_image_writers_byte_identical(tmp_path, seed):
    img = np.random.default_rng(seed).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    paths = {k: tmp_path / k for k in ("j.ppm", "t.ppm", "j.png", "t.png")}
    j_io.write_ppm(str(paths["j.ppm"]), img)
    t_io.write_ppm(str(paths["t.ppm"]), img)
    j_io.write_png(str(paths["j.png"]), img)
    t_io.write_png(str(paths["t.png"]), img)
    assert paths["j.ppm"].read_bytes() == paths["t.ppm"].read_bytes()
    assert paths["j.png"].read_bytes() == paths["t.png"].read_bytes()
    assert np.array_equal(t_io.read_ppm(str(paths["t.ppm"])), img)
    assert np.array_equal(t_io.read_png(str(paths["t.png"])), img)


def test_port_never_imports_jax_or_triton():
    code = (
        "import sys, raytracing_course_2024_tpu_torch as p\n"
        "import raytracing_course_2024_tpu_torch.runtime.cli\n"
        "import raytracing_course_2024_tpu_torch.ops.kernels\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'triton', 'raytracing_course_2024_tpu')]\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr

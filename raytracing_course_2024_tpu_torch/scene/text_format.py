"""Parser for the course text scene format.

The reference HEAD dropped its text parser (src/main.rs:48 has the call
commented out and the module is absent), but its ``scenes/practice3_*.txt``
inputs are part of the required surface (SURVEY.md section 2.2). Grammar
reconstructed from those files:

Global directives::

    DIMENSIONS w h          RAY_DEPTH n           SAMPLES n
    BG_COLOR r g b          CAMERA_POSITION x y z CAMERA_RIGHT x y z
    CAMERA_UP x y z         CAMERA_FORWARD x y z  CAMERA_FOV_X radians

Per primitive (started by ``NEW_PRIMITIVE``)::

    PLANE nx ny nz | ELLIPSOID rx ry rz | BOX sx sy sz
        | TRIANGLE ax ay az bx by bz cx cy cz
    POSITION x y z          ROTATION qx qy qz qw   COLOR r g b
    METALLIC | DIELECTRIC   IOR f                  EMISSION r g b

Vertical FOV is derived from the horizontal one by
``tan(fov_y/2) = tan(fov_x/2) * h/w`` (the course convention; the reference
renders with both tan(fov_x/2) and tan(fov_y/2) -- src/rendering.rs:76-77).
"""

from __future__ import annotations

import math

import numpy as np

from .types import (
    BOX,
    DIELECTRIC,
    DIFFUSE,
    ELLIPSOID,
    MIRROR,
    PLANE,
    TRI,
    CameraDesc,
    PrimitiveDesc,
    RenderSettings,
    SceneDesc,
)


def parse_text_scene(text: str) -> SceneDesc:
    width = height = 0
    ray_depth = 6
    samples = 1
    bg = np.zeros(3)
    cam_pos = np.zeros(3)
    cam_right = np.array([1.0, 0.0, 0.0])
    cam_up = np.array([0.0, 1.0, 0.0])
    cam_fwd = np.array([0.0, 0.0, -1.0])
    fov_x = math.pi / 2

    prims: list[PrimitiveDesc] = []
    planes: list[PrimitiveDesc] = []
    cur: PrimitiveDesc | None = None

    def flush():
        nonlocal cur
        if cur is None:
            return
        (planes if cur.ptype == PLANE else prims).append(cur)
        cur = None

    for raw_line in text.splitlines():
        tokens = raw_line.split()
        if not tokens:
            continue
        cmd, args = tokens[0], [float(t) for t in tokens[1:]]
        if cmd == "DIMENSIONS":
            width, height = int(args[0]), int(args[1])
        elif cmd == "RAY_DEPTH":
            ray_depth = int(args[0])
        elif cmd == "SAMPLES":
            samples = int(args[0])
        elif cmd == "BG_COLOR":
            bg = np.array(args[:3])
        elif cmd == "CAMERA_POSITION":
            cam_pos = np.array(args[:3])
        elif cmd == "CAMERA_RIGHT":
            cam_right = np.array(args[:3])
        elif cmd == "CAMERA_UP":
            cam_up = np.array(args[:3])
        elif cmd == "CAMERA_FORWARD":
            cam_fwd = np.array(args[:3])
        elif cmd == "CAMERA_FOV_X":
            fov_x = args[0]
        elif cmd == "NEW_PRIMITIVE":
            flush()
            cur = PrimitiveDesc(mkind=DIFFUSE)
        elif cur is not None:
            _primitive_directive(cur, cmd, args)
        # unknown top-level directives are ignored (course files contain none)

    flush()
    fov_y = 2.0 * math.atan(math.tan(fov_x / 2.0) * height / max(width, 1))
    settings = RenderSettings(
        width=width,
        height=height,
        samples=samples,
        ray_depth=ray_depth,
        bg_color=tuple(float(c) for c in bg),
        camera=CameraDesc(
            position=cam_pos,
            right=cam_right,
            up=cam_up,
            forward=cam_fwd,
            fov_x=fov_x,
            fov_y=fov_y,
        ),
    )
    return SceneDesc(settings=settings, primitives=prims, planes=planes)


def _primitive_directive(cur: PrimitiveDesc, cmd: str, args: list) -> None:
    if cmd == "PLANE":
        cur.ptype = PLANE
        cur.p0 = np.array(args[:3])
    elif cmd == "ELLIPSOID":
        cur.ptype = ELLIPSOID
        cur.p0 = np.array(args[:3])
    elif cmd == "BOX":
        cur.ptype = BOX
        cur.p0 = np.array(args[:3])
    elif cmd == "TRIANGLE":
        cur.ptype = TRI
        a = np.array(args[0:3])
        b = np.array(args[3:6])
        c = np.array(args[6:9])
        cur.p0, cur.p1, cur.p2 = a, b, c
        n = np.cross(b - a, c - a)
        n = n / max(np.linalg.norm(n), 1e-30)
        cur.sn0 = cur.sn1 = cur.sn2 = n
    elif cmd == "POSITION":
        cur.position = np.array(args[:3])
    elif cmd == "ROTATION":
        q = np.array(args[:4])  # (x, y, z, w)
        cur.rotation = q / max(np.linalg.norm(q), 1e-30)
    elif cmd == "COLOR":
        cur.color = np.array(args[:3])
    elif cmd == "METALLIC":
        cur.mkind = MIRROR
    elif cmd == "DIELECTRIC":
        cur.mkind = DIELECTRIC
    elif cmd == "IOR":
        cur.ior = args[0]
    elif cmd == "EMISSION":
        cur.emission = np.array(args[:3])


def load_text_scene(path: str) -> SceneDesc:
    with open(path, "r") as f:
        return parse_text_scene(f.read())

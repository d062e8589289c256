"""Image output: binary PPM (P6) and PNG, byte-identical to the JAX
package's ``runtime/image_io.py``.

Reference: src/main.rs:75-95. One deliberate fix: the reference opens the PPM
with ``append(true)`` so reruns concatenate images into one file
(src/main.rs:62-66, flagged in SURVEY.md section 2.1); we truncate.
"""

from __future__ import annotations

import numpy as np


def write_ppm(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) u8."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"P6\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"255\n")
        f.write(np.ascontiguousarray(img).tobytes())


def read_ppm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header: magic, dims, maxval separated by whitespace
    parts = []
    i = 0
    while len(parts) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":  # comment
            while data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        parts.append(data[i:j])
        i = j
    i += 1  # single whitespace after maxval
    assert parts[0] == b"P6", "only binary PPM supported"
    w, h = int(parts[1]), int(parts[2])
    return np.frombuffer(data, np.uint8, count=w * h * 3, offset=i).reshape(h, w, 3)


def write_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(img, mode="RGB").save(path, format="PNG")


def read_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))

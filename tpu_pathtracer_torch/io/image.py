"""Image IO: a dependency-free PNG writer (numpy), for `Renderer.screenshot`.

The writer half of `tpu_pathtracer.io.image` (the reference's
`canvas.toDataURL("image/png")` screenshot path, src/main.ts:351-356).
Render arrays use row 0 = bottom (camera space); `flip_vertical=True`
converts to display orientation.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    """[0,1] float -> uint8 with round-half-away like canvas export."""
    return np.clip(np.asarray(img, np.float32) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def encode_png(img: np.ndarray, flip_vertical: bool = False) -> bytes:
    """Encode (H, W, 3) float [0,1] or uint8 image to PNG bytes."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if flip_vertical:
        arr = arr[::-1]
    h, w = arr.shape[:2]
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    arr = arr[..., :3]

    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, img: np.ndarray, flip_vertical: bool = False) -> None:
    """img: (H, W, 3) float [0,1] or uint8."""
    with open(path, "wb") as f:
        f.write(encode_png(img, flip_vertical=flip_vertical))

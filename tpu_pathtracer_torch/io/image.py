"""Image IO: a dependency-free PNG writer and reader (numpy, zlib, struct).

The port of `tpu_pathtracer.io.image`: the writer serves
`Renderer.screenshot` and the viewer (the reference's
`canvas.toDataURL("image/png")` screenshot path, src/main.ts:351-356),
the reader the golden snapshots under tests/golden/.
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


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for RGB8/RGBA8 non-interlaced images -> (H, W, C) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", payload[:10])
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
        pos += 12 + length
    if bit_depth != 8 or color_type not in (2, 6):
        raise ValueError(f"{path}: only RGB8/RGBA8 PNGs are supported")
    channels = 3 if color_type == 2 else 4
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        line = np.frombuffer(raw, np.uint8, stride, pos + 1).copy()
        pos += 1 + stride
        if ft == 0:
            pass
        elif ft == 1:  # Sub
            for i in range(channels, stride):
                line[i] = (int(line[i]) + int(line[i - channels])) & 0xFF
        elif ft == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ft == 3:  # Average
            for i in range(stride):
                left = int(line[i - channels]) if i >= channels else 0
                line[i] = (int(line[i]) + ((left + int(prev[i])) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for i in range(stride):
                a = int(line[i - channels]) if i >= channels else 0
                b = int(prev[i])
                c = int(prev[i - channels]) if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"unsupported filter {ft}")
        out[y] = line
        prev = line
    return out.reshape(h, w, channels)

"""Radiance HDR (.hdr / RGBE) reader and writer: the port's copy of
`tpu_pathtracer.io.hdr` (numpy only), byte for byte the same output.

Replaces the reference's three.js RGBELoader for environment maps
(reference: src/main.ts:41-47 loading public/static/env/*.hdr into the
1024x512 rgba32float environment texture, src/renderer.ts:132-157).

Format: ASCII header ("#?RADIANCE", FORMAT=32-bit_rle_rgbe, "-Y H +X W"
resolution line), then per-scanline data either flat RGBE quadruplets or
adaptive-RLE (scanline starts with 0x02 0x02 when W in [8, 32767]).
Decoding: rgb = (mantissa + 0) * 2^(exponent - 136) — i.e.
ldexp(c, e - 128 - 8), matching RGBELoader's rgbe2float.
"""

from __future__ import annotations

import numpy as np


def _decode_rgbe(rgbe: np.ndarray) -> np.ndarray:
    """(..., 4) uint8 RGBE -> (..., 3) float32."""
    rgbe = rgbe.astype(np.int32)
    exp = rgbe[..., 3]
    scale = np.ldexp(np.float32(1.0), exp - 136).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[exp == 0] = 0.0
    return out


def _encode_rgbe(rgb: np.ndarray) -> np.ndarray:
    """(..., 3) float32 -> (..., 4) uint8 RGBE."""
    rgb = np.maximum(rgb.astype(np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    out = np.zeros(rgb.shape[:-1] + (4,), np.uint8)
    nz = maxc >= 1e-32
    mant, exp = np.frexp(maxc[nz])
    scale = mant * 256.0 / maxc[nz]
    out[nz, :3] = np.clip(rgb[nz] * scale[:, None], 0, 255).astype(np.uint8)
    out[nz, 3] = (exp + 128).astype(np.uint8)
    return out


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> (H, W, 3) float32 linear radiance.

    Row 0 is the TOP of the image (the "-Y H +X W" convention), matching what
    the reference uploads to its env texture.
    """
    with open(path, "rb") as f:
        data = f.read()

    # --- header ---------------------------------------------------------
    pos = 0

    def readline():
        nonlocal pos
        end = data.index(b"\n", pos)
        line = data[pos:end]
        pos = end + 1
        return line

    magic = readline()
    if not (magic.startswith(b"#?RADIANCE") or magic.startswith(b"#?RGBE")):
        raise ValueError(f"not a Radiance HDR file: {magic[:20]!r}")
    fmt = None
    while True:
        line = readline()
        if line.startswith(b"FORMAT="):
            fmt = line.split(b"=", 1)[1].strip()
        if line == b"":
            break
    if fmt not in (None, b"32-bit_rle_rgbe"):
        raise ValueError(f"unsupported HDR format {fmt!r}")
    res = readline().split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported resolution line {b' '.join(res)!r}")
    height, width = int(res[1]), int(res[3])

    raw = np.frombuffer(data, np.uint8, count=len(data) - pos, offset=pos)
    img = np.zeros((height, width, 4), np.uint8)
    p = 0
    for y in range(height):
        if (
            width >= 8
            and width <= 0x7FFF
            and p + 4 <= len(raw)
            and raw[p] == 2
            and raw[p + 1] == 2
            and ((int(raw[p + 2]) << 8) | int(raw[p + 3])) == width
        ):
            # adaptive RLE: 4 separated component streams
            p += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(raw[p])
                    p += 1
                    if count > 128:  # run
                        img[y, x : x + count - 128, c] = raw[p]
                        p += 1
                        x += count - 128
                    else:  # literal
                        img[y, x : x + count, c] = raw[p : p + count]
                        p += count
                        x += count
        else:
            # flat scanline (possibly old-style RLE, not emitted by modern
            # writers; handle the 1,1,1 repeat marker defensively)
            x = 0
            while x < width:
                quad = raw[p : p + 4]
                if quad[0] == 1 and quad[1] == 1 and quad[2] == 1 and x > 0:
                    count = int(quad[3])
                    img[y, x : x + count] = img[y, x - 1]
                    x += count
                else:
                    img[y, x] = quad
                    x += 1
                p += 4
    return _decode_rgbe(img)


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float32 -> flat (non-RLE) Radiance .hdr."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    rgbe = _encode_rgbe(img[..., :3])
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())

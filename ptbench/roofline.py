"""Peaks of the card and the work of the kernels the benchmark holds to them.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at the full
700 W power limit.  A share of a roofline is the least time the card could
take (the larger of operations over the FP32 peak and bytes over the HBM
rate) over the kernel's measured time.
"""

from __future__ import annotations

from .reference import post

H100_FP32 = 67e12  # FLOP/s, non-tensor FP32
H100_HBM = 3.35e12  # bytes/s


def bound_s(ops: float, nbytes: float):
    """(least seconds, what binds: "operations" or "bytes")."""
    t_ops, t_bytes = ops / H100_FP32, nbytes / H100_HBM
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def denoise_work(height: int, width: int):
    """(FP32 operations, bytes) of one denoise of an (height, width, 3)
    float32 image: per pixel and tap the difference, its squared norm, the
    exponential, the weight and the two sums (17), and a two-row blend on
    a tap with a fractional row offset (9 more); the final division (3);
    each input byte read once and each output byte written once."""
    per_pixel = 3
    for _, dy, _ in post.taps():
        per_pixel += 17 + (9 if dy != int(dy) else 0)
    return height * width * per_pixel, 2 * height * width * 3 * 4

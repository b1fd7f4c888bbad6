"""Draco mesh compression codec (native C++, ctypes binding).

The port of `tpu_pathtracer.io.draco`: the same functions over a
byte-equal copy of the repository's from-scratch codec,
`csrc/draco_codec.cpp` (tests/test_torch_draco.py holds the two equal).
It implements the Draco 2.2 bitstream in both directions, so
`io.gltf.save_glb(..., draco=True)` writes KHR_draco_mesh_compression
GLBs that `load_gltf` reads back.

Supported subset: the sequential method (uncompressed connectivity) and the
edgebreaker method (standard CLERS traversal; the encoder applies it to
closed 2-manifold genus-0 meshes and falls back to sequential otherwise);
raw-float or quantized-integer attributes (PREDICTION_NONE), values
raw-width or rANS-entropy-coded.  Valence-coded edgebreaker streams raise
DracoError.

`_build.build_cxx` (g++ -O3 -fPIC -shared -std=c++17) builds the codec on
first use into the build directory (`_build.build_dir()`), named by a hash of the flags
and the source, under a temporary name that is then renamed.  There is no
silent fallback: a codec that does not build raises with the compiler's
message, and TPU_PT_NO_NATIVE makes `encode` and `decode` raise
DracoError, as in the JAX package.

One guard the C++ lacks: its rANS encoder puts no cap on the alphabet,
while its decoder rejects more than 2^18 symbols, so `encode(...,
rans=True)` raises DracoError before encoding an attribute whose
quantisation would need a larger alphabet (more than 17 bits on values
that are not all equal).
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .._build import build_cxx, cxx_library_path

ATT_POSITION, ATT_NORMAL, ATT_COLOR, ATT_TEX_COORD, ATT_GENERIC = range(5)

_ATT_NAMES = {0: "POSITION", 1: "NORMAL", 2: "COLOR", 3: "TEX_COORD", 4: "GENERIC"}

SRC = Path(__file__).resolve().parent.parent / "csrc" / "draco_codec.cpp"
RANS_MAX_ALPHABET = 1 << 18  # read_prob_table's limit in csrc/draco_codec.cpp

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class DracoError(ValueError):
    pass


def library_path() -> Path:
    """Where the codec library for the current source and flags lives."""
    return cxx_library_path(SRC, "libtpt_draco")


def build() -> Path:
    """Compile the codec unless its library exists; returns its path.
    Raises RuntimeError with the compiler's output if g++ fails."""
    return build_cxx(SRC, "libtpt_draco", "Draco codec")


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded codec; None if TPU_PT_NO_NATIVE is set.  Builds it on
    first use; raises if it cannot be built or loaded."""
    global _lib
    if os.environ.get("TPU_PT_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64, u8p, u32p, f32p, i64p = (
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        )
        lib.tpu_pt_draco_last_error.restype = ctypes.c_char_p
        lib.tpu_pt_draco_last_error.argtypes = []
        lib.tpu_pt_draco_open.restype = ctypes.c_void_p
        lib.tpu_pt_draco_open.argtypes = [u8p, i64]
        lib.tpu_pt_draco_close.restype = None
        lib.tpu_pt_draco_close.argtypes = [ctypes.c_void_p]
        lib.tpu_pt_draco_h_info.restype = i64
        lib.tpu_pt_draco_h_info.argtypes = [ctypes.c_void_p, i64p]
        lib.tpu_pt_draco_h_attr_info.restype = i64
        lib.tpu_pt_draco_h_attr_info.argtypes = [ctypes.c_void_p, i64, i64p]
        lib.tpu_pt_draco_h_indices.restype = i64
        lib.tpu_pt_draco_h_indices.argtypes = [ctypes.c_void_p, u32p]
        lib.tpu_pt_draco_h_attr_f32.restype = i64
        lib.tpu_pt_draco_h_attr_f32.argtypes = [ctypes.c_void_p, i64, f32p]
        lib.tpu_pt_draco_info.restype = i64
        lib.tpu_pt_draco_info.argtypes = [u8p, i64, i64p]
        lib.tpu_pt_draco_attr_info.restype = i64
        lib.tpu_pt_draco_attr_info.argtypes = [u8p, i64, i64, i64p]
        lib.tpu_pt_draco_indices.restype = i64
        lib.tpu_pt_draco_indices.argtypes = [u8p, i64, u32p]
        lib.tpu_pt_draco_attr_f32.restype = i64
        lib.tpu_pt_draco_attr_f32.argtypes = [u8p, i64, i64, f32p]
        lib.tpu_pt_draco_encode.restype = i64
        lib.tpu_pt_draco_encode.argtypes = [f32p, ctypes.c_void_p, i64, u32p, i64, i64, i64,
                                            u8p, i64]
        lib.tpu_pt_draco_encode2.restype = i64
        lib.tpu_pt_draco_encode2.argtypes = [f32p, ctypes.c_void_p, i64, u32p, i64, i64, i64,
                                             i64, i64, u8p, i64]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def _err(lib) -> str:
    return lib.tpu_pt_draco_last_error().decode("utf-8", "replace")


def _require_lib():
    lib = get_lib()
    if lib is None:
        raise DracoError(
            "native Draco codec disabled (TPU_PT_NO_NATIVE is set); decode Draco assets "
            "offline, e.g. `gltf-pipeline -i model.glb -o out.glb -d`"
        )
    return lib


def decode(data: bytes) -> Dict[str, object]:
    """Decode a Draco stream.

    Returns {"num_points": N, "indices": (F,3) int64, "attributes": [
    {unique_id, att_type, name, components, values (N,C) float32} ... ]}.
    """
    lib = _require_lib()
    buf = np.frombuffer(data, np.uint8)
    handle = lib.tpu_pt_draco_open(buf, np.int64(buf.size))  # one parse for every accessor
    if not handle:
        raise DracoError(_err(lib))
    try:
        info = np.zeros(3, np.int64)
        if lib.tpu_pt_draco_h_info(handle, info) != 0:
            raise DracoError(_err(lib))
        num_points, num_faces, num_attrs = (int(x) for x in info)

        idx = np.empty(3 * num_faces, np.uint32)
        if lib.tpu_pt_draco_h_indices(handle, idx) < 0:
            raise DracoError(_err(lib))

        attrs: List[Dict[str, object]] = []
        for j in range(num_attrs):
            ai = np.zeros(4, np.int64)
            if lib.tpu_pt_draco_h_attr_info(handle, j, ai) != 0:
                raise DracoError(_err(lib))
            unique_id, att_type, _dtype, comps = (int(x) for x in ai)
            vals = np.empty(num_points * comps, np.float32)
            if lib.tpu_pt_draco_h_attr_f32(handle, j, vals) < 0:
                raise DracoError(_err(lib))
            attrs.append({
                "unique_id": unique_id,
                "att_type": att_type,
                "name": _ATT_NAMES.get(att_type, "GENERIC"),
                "components": comps,
                "values": vals.reshape(num_points, comps),
            })
    finally:
        lib.tpu_pt_draco_close(handle)
    return {
        "num_points": num_points,
        "indices": idx.astype(np.int64).reshape(-1, 3),
        "attributes": attrs,
    }


def rans_alphabet(values: np.ndarray, bits: int) -> int:
    """The alphabet `encode_symbols_rans` writes for one attribute quantised
    to `bits`: the zigzag codes 0 .. 2 * max q, where max q is 2^bits - 1
    unless every value is equal (then 0).  0 for a raw float attribute."""
    if not 0 < bits <= 30 or values.size == 0:
        return 0
    spread = (values.max(axis=0) > values.min(axis=0)).any()
    return 2 * ((1 << bits) - 1) + 1 if spread else 1


def encode(
    positions: np.ndarray,
    indices: np.ndarray,
    normals: Optional[np.ndarray] = None,
    *,
    position_bits: int = 14,
    normal_bits: int = 10,
    method: str = "sequential",
    rans: bool = False,
) -> bytes:
    """Encode a triangle mesh to a Draco stream.

    position_bits/normal_bits: quantization bit depth (0 = lossless raw
    float32).  Attribute unique ids: POSITION=0, NORMAL=1 (used by the glTF
    KHR_draco_mesh_compression attribute map).

    method: 'sequential' or 'edgebreaker'.  The edgebreaker path (CLERS
    connectivity) applies to closed 2-manifold genus-0 meshes with every
    vertex referenced, silently falling back to sequential otherwise —
    byte 8 of the returned stream names the method actually used.
    rans=True entropy-codes quantized attribute values with the rANS coder
    (requires position_bits/normal_bits > 0 to compress); it raises
    DracoError where an alphabet would pass the decoder's 2^18 limit.
    """
    if method not in ("sequential", "edgebreaker"):
        raise DracoError(f"unknown encode method {method!r}")
    lib = _require_lib()
    pos = np.ascontiguousarray(positions, np.float32)
    idx = np.ascontiguousarray(np.asarray(indices).reshape(-1, 3), np.uint32)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise DracoError("positions must be (N,3)")
    nrm = None
    nrm_ptr = None
    if normals is not None:
        nrm = np.ascontiguousarray(normals, np.float32)
        if nrm.shape != pos.shape:
            raise DracoError("normals must match positions shape")
        nrm_ptr = nrm.ctypes.data_as(ctypes.c_void_p)
    if rans:
        for name, values, bits in (("POSITION", pos, position_bits),
                                   ("NORMAL", nrm, normal_bits)):
            size = 0 if values is None else rans_alphabet(values, bits)
            if size > RANS_MAX_ALPHABET:
                raise DracoError(
                    f"rANS alphabet of {size} symbols for {name} at {bits} bits passes the "
                    f"decoder's limit of {RANS_MAX_ALPHABET}; use at most 17 bits with rans=True")
    n, f = pos.shape[0], idx.shape[0]
    m = np.int64(1 if method == "edgebreaker" else 0)
    rv = np.int64(1 if rans else 0)
    cap = 64 + 12 * 4 * n + 16 * f + 256
    out = np.empty(cap, np.uint8)
    size = lib.tpu_pt_draco_encode2(
        pos, nrm_ptr, np.int64(n), idx.reshape(-1), np.int64(f),
        np.int64(position_bits), np.int64(normal_bits), m, rv, out, np.int64(cap),
    )
    if size < 0:
        raise DracoError(_err(lib))
    if size > cap:  # retry with the exact size
        out = np.empty(int(size), np.uint8)
        size = lib.tpu_pt_draco_encode2(
            pos, nrm_ptr, np.int64(n), idx.reshape(-1), np.int64(f),
            np.int64(position_bits), np.int64(normal_bits), m, rv, out, np.int64(size),
        )
        if size < 0:
            raise DracoError(_err(lib))
    return bytes(out[:int(size)].tobytes())

"""ctypes binding of the native (C++) BVH builder, `csrc/bvh_builder.cpp`.

The source is a byte-equal copy of the repository's `csrc/bvh_builder.cpp`
inside the port (tests/test_torch_native_bvh.py holds the two equal).  It
makes the numpy builder's exact decisions (double-precision sweep SAH,
the same BFS flatten and skip links), so its arrays are byte-equal to
`accel.bvh`'s numpy path, at a fraction of the host time on large meshes.

`g++ -O3 -fPIC -shared -std=c++17` builds it on first use into
`build/tpu_pathtracer_torch/`, named by a hash of the flags and the
source, so a changed source rebuilds and an unchanged one loads at once.
The build writes a temporary name and renames it, so processes that build
at the same time never load a half-written library; a lock serialises the
threads of one process.

There is no silent fallback: when the native builder is asked for and
cannot be built or loaded, `get_lib` raises with the compiler's message.
Setting TPU_PT_NO_NATIVE selects the numpy builder instead (`get_lib`
returns None), as in the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from .._build import BUILD_DIR

SRC = Path(__file__).resolve().parent.parent / "csrc" / "bvh_builder.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libtpt_bvh_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the builder unless the library for this source exists;
    returns its path.  Raises RuntimeError with the compiler's output if
    g++ fails or is missing."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native BVH build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native BVH build failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library; None if TPU_PT_NO_NATIVE is set (the
    numpy builder is selected).  Builds it on first use; raises if it
    cannot be built or loaded."""
    global _lib
    if os.environ.get("TPU_PT_NO_NATIVE"):
        return None
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        i64, f32p, i32p = (
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
        )
        lib.tpu_pt_bvh_build.restype = i64
        lib.tpu_pt_bvh_build.argtypes = [f32p, f32p, f32p, i64, f32p, f32p, i32p, i32p, i32p,
                                         i32p]
        lib.tpu_pt_bvh_links.restype = i64
        lib.tpu_pt_bvh_links.argtypes = [f32p, f32p, i32p, i32p, i32p, i32p, i64, i64,
                                         f32p, f32p, i32p, i32p]
        _lib = lib
        return _lib


def _empty(keys) -> Dict[str, np.ndarray]:
    return {k: np.zeros((0, 3) if k in ("min", "max") else (0,),
                        np.float32 if k in ("min", "max") else np.int32) for k in keys}


def build_bvh_flat_native(lib: ctypes.CDLL, p0, p1, p2) -> Dict[str, np.ndarray]:
    """The flat BFS BVH of `accel.bvh.build_bvh_flat` through `lib`."""
    p0, p1, p2 = (np.ascontiguousarray(p, np.float32) for p in (p0, p1, p2))
    n = p0.shape[0]
    if not p0.shape == p1.shape == p2.shape == (n, 3):
        raise ValueError(f"vertices must be three (N, 3) arrays, got {p0.shape}, {p1.shape}, "
                         f"{p2.shape}")
    if n == 0:
        return _empty(("min", "max", "left", "right", "tri", "is_leaf"))
    k = 2 * n - 1
    out = {"min": np.empty((k, 3), np.float32), "max": np.empty((k, 3), np.float32),
           **{key: np.empty((k,), np.int32) for key in ("left", "right", "tri", "is_leaf")}}
    got = lib.tpu_pt_bvh_build(p0, p1, p2, n, out["min"], out["max"], out["left"],
                               out["right"], out["tri"], out["is_leaf"])
    if got != k:
        raise RuntimeError(f"native BVH build returned {got} nodes for {n} triangles, not {k}")
    return out


def flat_to_links_native(lib: ctypes.CDLL, flat: Dict[str, np.ndarray],
                         end: Optional[int] = None) -> Dict[str, np.ndarray]:
    """The skip-link layout of `accel.bvh.flat_to_links` through `lib`."""
    k = int(flat["left"].shape[0])
    end = k if end is None else end
    if k == 0:
        return _empty(("min", "max", "tri", "miss"))
    arrays = {key: np.ascontiguousarray(flat[key], np.float32 if key in ("min", "max") else
                                        np.int32)
              for key in ("min", "max", "left", "right", "tri", "is_leaf")}
    for key, a in arrays.items():
        if a.shape != ((k, 3) if key in ("min", "max") else (k,)):
            raise ValueError(f"flat[{key!r}] has shape {a.shape} for {k} nodes")
    out = {"min": np.empty((k, 3), np.float32), "max": np.empty((k, 3), np.float32),
           "tri": np.empty((k,), np.int32), "miss": np.empty((k,), np.int32)}
    got = lib.tpu_pt_bvh_links(*arrays.values(), k, end, out["min"], out["max"], out["tri"],
                               out["miss"])
    if got != k:
        raise RuntimeError(f"native BVH links returned {got} nodes, not {k}")
    return out

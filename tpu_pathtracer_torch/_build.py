"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` of the package, one process per source,
all started together, and links the objects into one shared library with a
plain C interface, for sm_90a, without fast-math and with `-fmad=false` (no
contraction of products and sums into FMAs, so kernels round like their
plain PyTorch versions).  The library goes to `build/tpu_pathtracer_torch/`
beside the package, named by a hash of the sources, the shared headers
(`csrc/*.cuh`) and the flags, so a changed source or header rebuilds and an
unchanged tree loads at once.  `ctypes` binds it; every entry point returns
a CUDA error code.

Nothing here runs at import: the first kernel launch calls `load()`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tpu_pathtracer_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME")
    return str(path)


def library_path() -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtpt_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> list[tuple[int, str]]:
    """Run the commands side by side; (exit code, output) of each, in order."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs = [proc.communicate()[0] for proc in procs]
    return [(proc.returncode, text) for proc, text in zip(procs, outputs)]


def build() -> Path:
    """Compile the kernels unless the library for these sources exists;
    returns its path.  The compilers' output (with ptxas register and
    shared-memory counts) is kept beside it as a .log file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    results = _run_all(cmds)
    if not any(rc for rc, _ in results):
        cmds.append([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)])
        results += _run_all(cmds[-1:])
    out.with_suffix(".log").write_text(
        "".join(" ".join(c) + "\n" + text for c, (_, text) in zip(cmds, results)))
    for obj in objs:
        obj.unlink(missing_ok=True)
    for cmd, (rc, text) in zip(cmds, results):
        if rc:
            raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{text[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tpt_mt_nf.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.tpt_mt_nf.restype = i
    lib.tpt_mt_nf_variant.argtypes = [p] * 10 + [i] * 9 + [p]
    lib.tpt_mt_nf_variant.restype = i
    lib.tpt_mt_nf_shape.argtypes = [i, i, ctypes.POINTER(i)]
    lib.tpt_mt_nf_shape.restype = i
    lib.tpt_mt_nf_v1.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.tpt_mt_nf_v1.restype = i
    lib.tpt_mt_list.argtypes = [p] * 8 + [i] * 5 + [p]
    lib.tpt_mt_list.restype = i
    lib.tpt_mt_cond.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.tpt_mt_cond.restype = i
    lib.tpt_mt_nf_mxu.argtypes = lib.tpt_mt_nf_v1.argtypes
    lib.tpt_mt_nf_mxu.restype = i
    lib.tpt_mt_list_mxu.argtypes = lib.tpt_mt_list.argtypes
    lib.tpt_mt_list_mxu.restype = i
    lib.tpt_mt_cond_mxu.argtypes = lib.tpt_mt_cond.argtypes
    lib.tpt_mt_cond_mxu.restype = i
    lib.tpt_mxu_smem_bytes.argtypes = [i, i]
    lib.tpt_mxu_smem_bytes.restype = ctypes.c_size_t
    lib.tpt_mxu_smem_limit.argtypes = [i, ctypes.POINTER(ctypes.c_size_t)]
    lib.tpt_mxu_smem_limit.restype = i
    lib.tpt_mt_stream.argtypes = [p] * 12 + [i] * 6 + [p]
    lib.tpt_mt_stream.restype = i
    lib.tpt_mt_stream_variant.argtypes = [p] * 12 + [i] * 11 + [p]
    lib.tpt_mt_stream_variant.restype = i
    lib.tpt_mt_stream_shape.argtypes = [i, ctypes.POINTER(i)]
    lib.tpt_mt_stream_shape.restype = i
    lib.tpt_mt_stream_v1.argtypes = lib.tpt_mt_stream.argtypes
    lib.tpt_mt_stream_v1.restype = i
    lib.tpt_mt_r2.argtypes = [p] * 8 + [i] * 4 + [p]
    lib.tpt_mt_r2.restype = i
    lib.tpt_denoise.argtypes = [p, p, p, i, i, i, f, p]
    lib.tpt_denoise.restype = i
    lib.tpt_error_string.argtypes = [i]
    lib.tpt_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return f"{err} ({load().tpt_error_string(err).decode()})"

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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Every C entry point: (argument types, result type).
_SIGNATURES = {
    "tpt_mt_nf": ([_P] * 10 + [_I] * 5 + [_P], _I),
    "tpt_mt_nf_shape": ([_I, _I, ctypes.POINTER(_I)], _I),
    "tpt_mt_list": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "tpt_mt_list_shape": ([_I, _I, ctypes.POINTER(_I)], _I),
    "tpt_mt_list_v1": ([_P] * 8 + [_I] * 5 + [_P], _I),
    "tpt_mt_cond": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "tpt_mt_cond_shape": ([_I, _I, ctypes.POINTER(_I)], _I),
    "tpt_mt_cond_v1": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "tpt_mt_nf_mxu": ([_P] * 10 + [_I] * 5 + [_P], _I),
    "tpt_mt_list_mxu": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "tpt_mt_cond_mxu": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "tpt_mt_nf_mxu_shape": ([_I, _I, ctypes.POINTER(_I)], _I),
    "tpt_mt_list_mxu_shape": ([_I, _I, ctypes.POINTER(_I)], _I),
    "tpt_mt_cond_mxu_shape": ([_I, _I, ctypes.POINTER(_I)], _I),
    "tpt_mt_nf_mxu_v1": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "tpt_mt_list_mxu_v1": ([_P] * 8 + [_I] * 5 + [_P], _I),
    "tpt_mt_cond_mxu_v1": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "tpt_mxu_smem_bytes": ([_I, _I], ctypes.c_size_t),
    "tpt_mxu_smem_limit": ([_I, ctypes.POINTER(ctypes.c_size_t)], _I),
    "tpt_mt_stream": ([_P] * 12 + [_I] * 6 + [_P], _I),
    "tpt_mt_stream_shape": ([_I, ctypes.POINTER(_I)], _I),
    "tpt_mt_r2_walk": ([_P] * 8 + [_I] * 3 + [_P], _I),
    "tpt_mt_r2_walk_shape": ([ctypes.POINTER(_I)], _I),
    "tpt_mt_r2_v1": ([_P] * 8 + [_I] * 4 + [_P], _I),
    "tpt_denoise": ([_P] * 4 + [_I] * 4 + [_F, _P], _I),
    "tpt_denoise_v1": ([_P] * 3 + [_I] * 3 + [_F, _P], _I),
    "tpt_error_string": ([_I], ctypes.c_char_p),
}


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, then load and declare the C entry points."""
    lib = ctypes.CDLL(str(build()))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


def error_string(err: int) -> str:
    return f"{err} ({load().tpt_error_string(err).decode()})"

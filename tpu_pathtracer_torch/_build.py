"""Build and load the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` of the package, one process per source,
all started together, and links the objects into one shared library with a
plain C interface, for sm_90a, without fast-math and with `-fmad=false` (no
contraction of products and sums into FMAs, so kernels round like their
plain PyTorch versions).  The library goes to the build directory
(`build_dir()`: `build/tpu_pathtracer_torch/` beside the package unless
`TPU_PATHTRACER_CACHE_DIR` or `utils.compcache.enable_compilation_cache`
places it elsewhere), named by a hash of the sources, the shared headers
(`csrc/*.cuh`) and the flags, so a changed source or header rebuilds and an
unchanged tree loads at once.  `ctypes` binds it; every entry point returns
a CUDA error code.

The host libraries (the native BVH builder and the Draco codec, plain
C++ over `ctypes`) are built by `build_cxx`: `g++ -O3 -fPIC -shared
-std=c++17` into the build directory, named by a hash of the flags and the
source, written under a temporary name and renamed, so processes that
build at the same time never load a half-written library.

Nothing here runs at import: the first kernel launch calls `load()`, the
first native call `build_cxx`.
"""

from __future__ import annotations

import atexit
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tpu_pathtracer_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)


CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
CACHE_ENV = "TPU_PATHTRACER_CACHE_DIR"

_cache_dir: Path | None = None  # pinned by enable_compilation_cache(cache_dir)
_fresh: tuple[int, Path] | None = None  # (pid, directory) when the cache is off


def _fresh_dir() -> Path:
    """A directory of this process's own, removed when it exits."""
    global _fresh
    pid = os.getpid()
    if _fresh is None or _fresh[0] != pid:  # a forked child makes its own
        path = Path(tempfile.mkdtemp(prefix="tpu_pathtracer_build_"))
        _fresh = (pid, path)
        atexit.register(lambda: os.getpid() == pid and shutil.rmtree(path, ignore_errors=True))
    return _fresh[1]


def build_dir() -> Path:
    """The directory every build writes to and every load reads from,
    resolved at each call: the directory pinned by
    `enable_compilation_cache(cache_dir)`, else `TPU_PATHTRACER_CACHE_DIR`
    (the empty string: a fresh directory for this process, so nothing is
    cached), else `BUILD_DIR`."""
    if _cache_dir is not None:
        return _cache_dir
    env = os.environ.get(CACHE_ENV)
    if env is None:
        return BUILD_DIR
    return _fresh_dir() if env == "" else Path(env)


def cxx_library_path(src: Path, stem: str) -> Path:
    """Where the g++ library of `src` (and the flags) lives: `stem_<hash>.so`."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(src.read_bytes())
    return build_dir() / f"{stem}_{h.hexdigest()[:16]}.so"


def build_cxx(src: Path, stem: str, what: str) -> Path:
    """Compile `src` with g++ unless its library exists; returns its path.
    Raises RuntimeError("<what> build failed ...") with the compiler's
    output if g++ fails or is missing."""
    out = cxx_library_path(src, stem)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.parent / f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so"
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(src)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{what} build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} build failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


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
    return build_dir() / f"libtpt_kernels_{h.hexdigest()[:16]}.so"


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
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in _sources()]
    tmp = out.parent / f"{tag}.tmp.so"
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
    "tpt_mt_cond": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "tpt_mt_cond_shape": ([_I, _I, ctypes.POINTER(_I)], _I),
    "tpt_mt_nf_mxu": ([_P] * 10 + [_I] * 5 + [_P], _I),
    "tpt_mt_list_mxu": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "tpt_mt_cond_mxu": ([_P] * 9 + [_I] * 5 + [_P], _I),
    "tpt_mt_nf_mxu_shape": ([_I, _I, ctypes.POINTER(_I)], _I),
    "tpt_mt_list_mxu_shape": ([_I, _I, ctypes.POINTER(_I)], _I),
    "tpt_mt_cond_mxu_shape": ([_I, _I, ctypes.POINTER(_I)], _I),
    "tpt_mt_stream": ([_P] * 12 + [_I] * 6 + [_P], _I),
    "tpt_mt_stream_shape": ([_I, ctypes.POINTER(_I)], _I),
    "tpt_mt_r2_walk": ([_P] * 8 + [_I] * 3 + [_P], _I),
    "tpt_mt_r2_walk_shape": ([ctypes.POINTER(_I)], _I),
    "tpt_precull": ([_P] * 5 + [_I] * 3 + [_P], _I),
    "tpt_fat_walk": ([_P] * 9 + [_I] * 4 + [_P], _I),
    "tpt_denoise": ([_P] * 4 + [_I] * 4 + [_F, _P], _I),
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

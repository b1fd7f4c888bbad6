"""The persistent build cache of the port's compiled libraries.

The port of `tpu_pathtracer.utils.compcache`.  Where the JAX package
caches XLA programs on disk, the port compiles its CUDA kernels (`nvcc`)
and host libraries (g++) at first use (`_build`), into a directory whose
files are named by a hash of their sources and flags: that directory is
the port's persistent cache, and `_build.build_dir()` resolves it at every
build and load.

`enable_compilation_cache` has the JAX function's contract:
`cache_dir`, else ``TPU_PATHTRACER_CACHE_DIR``, places the cache; the
variable set to the empty string turns it off (every process then builds
into a fresh directory of its own, removed at exit).  Unlike JAX's
``~/.cache/tpu_pathtracer/xla``, the default is the repo's git-ignored
``build/tpu_pathtracer_torch/``, where the libraries build when this
function is never called.  Safe to call more than once; never raises.
"""

from __future__ import annotations

import os
from pathlib import Path

from .. import _build


def enable_compilation_cache(cache_dir: str | None = None) -> str | None:
    """Build into and load from `cache_dir` (pinned for the process), or
    the directory `TPU_PATHTRACER_CACHE_DIR` names, or the default; returns
    the directory in use (None if the cache is disabled or the directory
    cannot be made)."""
    try:
        if os.environ.get(_build.CACHE_ENV) == "":
            return None
        if cache_dir:
            _build._cache_dir = Path(cache_dir)
        path = _build.build_dir()
        path.mkdir(parents=True, exist_ok=True)
        return str(path)
    except Exception:
        return None

"""The port's build cache (tpu_pathtracer_torch/utils/compcache.py).

`enable_compilation_cache` keeps the JAX function's contract
(tpu_pathtracer/utils/compcache.py): `cache_dir`, else
TPU_PATHTRACER_CACHE_DIR, places the cache, the empty string turns it off,
and it never raises.  Here the cache is the directory that every build
and load of the port's libraries resolves (`_build.build_dir()`): the
CUDA kernels', the native BVH builder's and the Draco codec's.  No test
needs nvcc; one builds the native BVH library with g++."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from tpu_pathtracer_torch import _build
from tpu_pathtracer_torch.accel import native
from tpu_pathtracer_torch.io import draco
from tpu_pathtracer_torch.utils.compcache import enable_compilation_cache

ROOT = Path(__file__).resolve().parent.parent
ENV = "TPU_PATHTRACER_CACHE_DIR"


@pytest.fixture(autouse=True)
def _unpinned(monkeypatch):
    """Every test starts with no directory pinned and the variable unset."""
    monkeypatch.setattr(_build, "_cache_dir", None)
    monkeypatch.delenv(ENV, raising=False)


def _every_library_dir():
    return {_build.library_path().parent, native.library_path().parent,
            draco.library_path().parent}


def test_default_is_the_git_ignored_build_directory():
    assert _build.build_dir() == _build.BUILD_DIR == ROOT / "build" / "tpu_pathtracer_torch"
    assert enable_compilation_cache() == str(_build.BUILD_DIR)
    assert _every_library_dir() == {_build.BUILD_DIR}
    assert "build/" in (ROOT / ".gitignore").read_text().split()


def test_argument_places_and_pins_the_cache(tmp_path):
    where = tmp_path / "cache"
    assert enable_compilation_cache(str(where)) == str(where) and where.is_dir()
    assert _every_library_dir() == {where}
    os.environ[ENV] = str(tmp_path / "other")  # monkeypatch restores it
    assert _build.build_dir() == where  # the argument wins, as in JAX
    assert enable_compilation_cache() == str(where)  # a second call keeps it


def test_environment_variable_places_the_cache(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV, str(tmp_path / "env"))
    assert enable_compilation_cache() == str(tmp_path / "env")
    assert (tmp_path / "env").is_dir() and _every_library_dir() == {tmp_path / "env"}


def test_empty_variable_disables_the_cache(monkeypatch, tmp_path):
    monkeypatch.setenv(ENV, "")
    assert enable_compilation_cache() is None
    assert enable_compilation_cache(str(tmp_path)) is None  # even with an argument, as in JAX
    fresh = _build.build_dir()
    assert fresh.is_dir() and fresh not in (_build.BUILD_DIR, tmp_path)
    assert _build.build_dir() == fresh and _every_library_dir() == {fresh}


def test_never_raises(tmp_path):
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    assert enable_compilation_cache(str(blocker / "cache")) is None


def test_native_library_builds_into_and_loads_from_the_cache(monkeypatch, tmp_path):
    monkeypatch.delenv("TPU_PT_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "_lib", None)
    enable_compilation_cache(str(tmp_path))
    path = native.build()
    assert path.parent == tmp_path and path.exists()
    lib = native.get_lib()
    assert Path(lib._name) == path


def test_a_disabled_cache_builds_in_a_directory_removed_at_exit(tmp_path):
    """A fresh interpreter with the variable empty: its builds land in a
    directory of its own, gone once it exits."""
    code = ("from tpu_pathtracer_torch import _build\n"
            "from tpu_pathtracer_torch.accel import native\n"
            "print(native.build().parent)\n")
    env = {**os.environ, ENV: "", "TPU_PT_NO_NATIVE": ""}
    env.pop("PYTHONSTARTUP", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    used = Path(proc.stdout.strip().splitlines()[-1])
    assert used.name.startswith("tpu_pathtracer_build_") and not used.exists()


def test_renderer_and_cli_enable_the_cache(monkeypatch, tmp_path):
    import tpu_pathtracer_torch as tpt
    from tpu_pathtracer_torch import cli
    from tpu_pathtracer_torch.scene.envmap import gradient_sky

    monkeypatch.setenv(ENV, str(tmp_path / "renderer"))
    scene = tpt.default_scene(gradient_sky(8, 16))
    tpt.Renderer(scene, tpt.Camera.create(), tpt.RenderConfig(width=8, height=8, frames=1),
                 device="cpu")
    assert (tmp_path / "renderer").is_dir()
    monkeypatch.setenv(ENV, str(tmp_path / "cli"))
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    assert (tmp_path / "cli").is_dir()

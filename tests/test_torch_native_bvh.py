"""Port parity: the native (C++) BVH builder, `accel.native`.

  * the port's `csrc/bvh_builder.cpp` is a byte-equal copy of the
    repository's `csrc/bvh_builder.cpp`;
  * native against the port's numpy builder (`native=False`), and against
    the JAX package's numpy builder (`native=False`, the oracle of
    tests/test_native_bvh.py:29-63): every array byte-equal, dtypes
    included.  The JAX package's own native library is never needed, so
    the comparison holds whether or not that library built and loaded;
  * a scene compiles to the same tensors under either builder;
  * TPU_PT_NO_NATIVE selects the numpy builder, and a source that does not
    compile raises with the compiler's message (no silent fallback).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from tpu_pathtracer.accel import bvh as jbvh
from tpu_pathtracer.accel import native as jnative
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch import _build
from tpu_pathtracer_torch.accel import bvh, native
from tpu_pathtracer_torch.scene.envmap import gradient_sky

ROOT = Path(__file__).resolve().parent.parent


def _random_tris(n, seed=0, spread=10.0, size=0.3):
    rng = np.random.default_rng(seed)
    c = (rng.random((n, 3)).astype(np.float32) - 0.5) * spread
    p1 = c + (rng.random((n, 3)).astype(np.float32) - 0.5) * size
    p2 = c + (rng.random((n, 3)).astype(np.float32) - 0.5) * size
    return c, p1, p2


def _coplanar(n=33):
    """Identical centroids: the stable sort's tie order must match."""
    base = np.zeros((n, 3), np.float32)
    return base, base + np.float32([1, 0, 0]), base + np.float32([0, 1, 0])


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_source_is_a_byte_equal_copy():
    assert native.SRC.read_bytes() == (ROOT / "csrc" / "bvh_builder.cpp").read_bytes()


CASES = {"1": lambda: _random_tris(1, 1), "7": lambda: _random_tris(7, 7),
         "1000": lambda: _random_tris(1000, 1000), "coplanar": _coplanar,
         "empty": lambda: (np.zeros((0, 3), np.float32),) * 3}


def _check_against_numpy_and_jax(case):
    p0, p1, p2 = CASES[case]()
    nat = bvh.build_bvh_flat(p0, p1, p2)
    _assert_same(nat, bvh.build_bvh_flat(p0, p1, p2, native=False))
    _assert_same(nat, jbvh.build_bvh_flat(p0, p1, p2, native=False))
    end = 2 * nat["left"].shape[0] + 3
    links = bvh.flat_to_links(nat, end=end)
    _assert_same(links, bvh.flat_to_links(nat, end=end, native=False))
    _assert_same(links, jbvh.flat_to_links(nat, end=end, native=False))


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_matches_numpy_and_jax_native(case):
    _check_against_numpy_and_jax(case)


def test_parity_holds_without_the_jax_native_library(monkeypatch):
    """The JAX package's loader latches "no library" for the rest of the
    process once a build or load fails (as when several processes build it
    at once); the port's comparison must not depend on that library."""
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    assert jnative.get_lib() is None
    for case in sorted(CASES):
        _check_against_numpy_and_jax(case)


def test_scene_compiles_the_same_under_either_builder(monkeypatch):
    scene = tpt.default_scene(gradient_sky(8, 16))
    a = scene.compile(device="cpu")
    monkeypatch.setenv("TPU_PT_NO_NATIVE", "1")
    b = scene.compile(device="cpu")
    for group in ("bvh", "links", "packed"):
        for f in dataclasses.fields(getattr(a, group)):
            name = f"{group}.{f.name}"
            x, y = getattr(getattr(a, group), f.name), getattr(getattr(b, group), f.name)
            assert x.dtype == y.dtype and x.numpy().tobytes() == y.numpy().tobytes(), name


def test_no_native_selects_numpy(monkeypatch):
    monkeypatch.setenv("TPU_PT_NO_NATIVE", "1")
    assert native.get_lib() is None

    def refuse(*args, **kwargs):
        raise AssertionError("the native builder ran under TPU_PT_NO_NATIVE")

    monkeypatch.setattr(native, "build_bvh_flat_native", refuse)
    monkeypatch.setattr(native, "flat_to_links_native", refuse)
    p0, p1, p2 = _random_tris(50, 3)
    flat = bvh.build_bvh_flat(p0, p1, p2)
    assert flat["left"].shape == (99,) and bvh.flat_to_links(flat)["miss"].shape == (99,)


def test_a_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    broken = tmp_path / "bvh_builder.cpp"
    broken.write_text(native.SRC.read_text() + "\nthis is not C++;\n")
    monkeypatch.delenv("TPU_PT_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "SRC", broken)
    monkeypatch.setattr(_build, "_cache_dir", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)native BVH build failed.*error"):
        bvh.build_bvh_flat(*_random_tris(5))
    assert not list((tmp_path / "build").glob("*.so"))  # nothing half-written is left


def test_library_is_named_by_its_source(monkeypatch, tmp_path):
    path = native.build()
    assert path.parent == _build.build_dir() and path.name.startswith("libtpt_bvh_")
    assert path == native.library_path() and path.exists()
    changed = tmp_path / "bvh_builder.cpp"
    changed.write_text(native.SRC.read_text() + "\n// a changed source\n")
    monkeypatch.setattr(native, "SRC", changed)
    assert native.library_path() != path  # a changed source builds a new library

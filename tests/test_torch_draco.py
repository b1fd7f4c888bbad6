"""Port parity: the Draco codec (`io.draco`) and the glTF writer's Draco
path, held to the JAX package on identical inputs.

  * the port's `csrc/draco_codec.cpp` is a byte-equal copy of the
    repository's `csrc/draco_codec.cpp`;
  * `encode` writes the JAX package's bytes (sequential, edgebreaker, rANS,
    lossless and quantised), and `decode` reads JAX's streams to the same
    arrays (edgebreaker decodes also held to the source mesh as oriented
    face sets, since CLERS renumbers vertices and faces);
  * the rANS guard: the C++ encoder writes alphabets its decoder rejects,
    the port's wrapper raises first;
  * truncated and hostile streams raise DracoError (tests/test_draco.py's
    cases, without the fuzz loops); TPU_PT_NO_NATIVE raises DracoError; a
    codec that does not compile raises with the compiler's message;
  * `save_glb(..., draco=True)` writes JAX's bytes, and `load_gltf` reads
    them back to JAX's meshes.

The JAX binding builds its library in place under csrc/build/, which
races when several processes build it at once and then latches "no
library" for the process.  So `jdraco` binds the JAX module to the port's
library, built from the byte-equal source, before any JAX call: what is
compared is the two packages' wrappers and glTF code.
"""

import struct
from pathlib import Path

import numpy as np
import pytest

from tpu_pathtracer.io import draco as jdraco_module
from tpu_pathtracer.io import gltf as jgltf
from tpu_pathtracer.scene import host as jhost
from tpu_pathtracer_torch import _build
from tpu_pathtracer_torch.io import draco, gltf
from tpu_pathtracer_torch.scene import host, primitives

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def jdraco(monkeypatch):
    """The JAX Draco module, bound to the port's codec library."""
    monkeypatch.delenv("TPU_PT_NO_NATIVE", raising=False)
    monkeypatch.setattr(jdraco_module, "_SRC", str(draco.SRC))
    monkeypatch.setattr(jdraco_module, "_SO", str(draco.build()))
    monkeypatch.setattr(jdraco_module, "_lib", None)
    monkeypatch.setattr(jdraco_module, "_tried", False)
    assert jdraco_module.get_lib() is not None
    return jdraco_module


def _mesh(n=500, f=900, seed=0):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((n, 3)) * 2).astype(np.float32)
    nrm = rng.standard_normal((n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    idx = rng.integers(0, n, (f, 3)).astype(np.uint32)
    return pos, nrm, idx


def _sphere(levels):
    """A subdivided octahedron on the unit sphere: closed, manifold, genus 0."""
    p = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                 np.float64)
    i = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                  [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    for _ in range(levels):
        pos, cache, out = list(p), {}, []

        def mid(a, b):
            k = (min(a, b), max(a, b))
            if k not in cache:
                m = (pos[a] + pos[b]) / 2
                cache[k] = len(pos)
                pos.append(m / np.linalg.norm(m))
            return cache[k]

        for a, b, c in i:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            out += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        p, i = np.array(pos), np.array(out)
    return p.astype(np.float32), p.astype(np.float32), i.astype(np.uint32)


def _faces(pos, idx, digits=4):
    """The mesh as a set of oriented faces (tests/test_draco.py's `_canon_faces`)."""
    faces = set()
    for tri in np.asarray(idx).reshape(-1, 3):
        vs = [tuple(np.round(np.asarray(pos)[v], digits)) for v in tri]
        k = min(range(3), key=lambda i: vs[i])
        faces.add(tuple(vs[k:] + vs[:k]))
    return faces


ENCODINGS = {
    "sequential_lossless": (lambda: _mesh(), dict(position_bits=0, normal_bits=0)),
    "sequential_14_10": (lambda: _mesh(), dict()),
    "sequential_positions_only": (lambda: _mesh()[::2], dict()),
    "sequential_rans_12_8": (lambda: _mesh(), dict(position_bits=12, normal_bits=8, rans=True)),
    "edgebreaker_lossless": (lambda: _sphere(2), dict(position_bits=0, normal_bits=0,
                                                      method="edgebreaker")),
    "edgebreaker_14_10": (lambda: _sphere(3), dict(method="edgebreaker")),
    "edgebreaker_rans_17": (lambda: _sphere(3), dict(position_bits=17, normal_bits=10,
                                                     method="edgebreaker", rans=True)),
}


def _encode(mod, case):
    make, kw = ENCODINGS[case]
    mesh = make()
    pos, idx = mesh[0], mesh[-1]
    nrm = mesh[1] if len(mesh) == 3 else None
    return mod.encode(pos, idx, nrm, **kw), (pos, nrm, idx)


def test_source_is_a_byte_equal_copy():
    assert draco.SRC.read_bytes() == (ROOT / "csrc" / "draco_codec.cpp").read_bytes()


@pytest.mark.parametrize("case", sorted(ENCODINGS))
def test_encode_writes_the_jax_bytes_and_decode_reads_them(case, jdraco):
    blob, (pos, nrm, idx) = _encode(draco, case)
    assert blob == _encode(jdraco, case)[0]
    assert blob[8] == (1 if "edgebreaker" in case else 0)  # the method actually used
    got, want = draco.decode(blob), jdraco.decode(blob)
    assert got["num_points"] == want["num_points"]
    assert got["indices"].dtype == want["indices"].dtype == np.int64
    np.testing.assert_array_equal(got["indices"], want["indices"])
    assert len(got["attributes"]) == len(want["attributes"]) == (1 if nrm is None else 2)
    for a, b in zip(got["attributes"], want["attributes"]):
        assert {k: v for k, v in a.items() if k != "values"} == \
               {k: v for k, v in b.items() if k != "values"}
        assert a["values"].dtype == b["values"].dtype == np.float32
        assert a["values"].tobytes() == b["values"].tobytes()
    values = got["attributes"][0]["values"]
    if "lossless" in case and "edgebreaker" in case:
        assert _faces(values, got["indices"]) == _faces(pos, idx)
    elif "lossless" in case:
        np.testing.assert_array_equal(values, pos)
        np.testing.assert_array_equal(got["indices"], idx.astype(np.int64))


def test_rans_guard_raises_where_the_decoder_would_refuse(jdraco):
    """At 18 bits the encoder's alphabet (2^19 - 1 zigzag codes) passes the
    decoder's 2^18 limit: JAX's wrapper writes a stream nothing can read,
    the port's raises before encoding.  17 bits is the widest that works."""
    pos, _, idx = _sphere(2)
    stream = jdraco.encode(pos, idx, position_bits=18, rans=True)
    with pytest.raises(jdraco.DracoError, match="alphabet"):
        jdraco.decode(stream)
    with pytest.raises(draco.DracoError, match="rANS alphabet of 524287"):
        draco.encode(pos, idx, position_bits=18, rans=True)
    with pytest.raises(draco.DracoError, match="NORMAL"):
        draco.encode(pos, idx, pos, position_bits=12, normal_bits=20, rans=True)
    assert draco.rans_alphabet(pos, 17) == (1 << 18) - 1
    draco.decode(draco.encode(pos, idx, position_bits=17, rans=True))
    flat = np.zeros_like(pos)  # equal values quantise to one symbol
    assert draco.rans_alphabet(flat, 24) == 1
    draco.decode(draco.encode(flat, idx, position_bits=24, rans=True))
    draco.decode(draco.encode(pos, idx, position_bits=24))  # raw width, no rANS


def _hostile_points():
    """tests/test_draco.py's ~40-byte stream claiming ~2^32 points."""
    def varu32(v):
        out = b""
        while v >= 0x80:
            out += bytes([v & 0x7F | 0x80])
            v >>= 7
        return out + bytes([v])

    return (b"DRACO" + bytes([2, 2, 1, 0]) + b"\x00\x00" + bytes([1]) + varu32(2**32 - 2)
            + bytes([1]) + b"\x00\x00\x00\x00" * 3 + bytes([1]) + varu32(1)
            + bytes([0, 9, 3, 0]) + varu32(0) + bytes([1]))


BAD_STREAMS = {
    "truncated": lambda: draco.encode(*_mesh()[::2])[:1000],
    "hostile_point_count": _hostile_points,
    "garbage_after_magic": lambda: b"DRACO" + bytes(np.random.default_rng(0).integers(
        0, 256, 64, dtype=np.uint8)),
}


@pytest.mark.parametrize("case", sorted(BAD_STREAMS))
def test_bad_streams_raise_dracoerror(case, jdraco):
    blob = BAD_STREAMS[case]()
    with pytest.raises(jdraco.DracoError) as want:
        jdraco.decode(blob)
    with pytest.raises(draco.DracoError) as got:
        draco.decode(blob)
    assert str(got.value) == str(want.value)


def test_no_native_raises_dracoerror(monkeypatch):
    monkeypatch.setenv("TPU_PT_NO_NATIVE", "1")
    assert not draco.available()
    pos, nrm, idx = _mesh(20, 30)
    with pytest.raises(draco.DracoError, match="TPU_PT_NO_NATIVE"):
        draco.encode(pos, idx, nrm)
    with pytest.raises(draco.DracoError, match="TPU_PT_NO_NATIVE"):
        draco.decode(b"DRACO")


def test_a_failed_build_raises_with_the_compiler_message(monkeypatch, tmp_path):
    broken = tmp_path / "draco_codec.cpp"
    broken.write_text(draco.SRC.read_text() + "\nthis is not C++;\n")
    monkeypatch.delenv("TPU_PT_NO_NATIVE", raising=False)
    monkeypatch.setattr(draco, "SRC", broken)
    monkeypatch.setattr(_build, "_cache_dir", tmp_path / "build")
    monkeypatch.setattr(draco, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)Draco codec build failed.*error"):
        draco.decode(b"DRACO")
    assert not list((tmp_path / "build").glob("*.so"))


def _meshes(mod_host):
    """A sphere with a transform and an emissive torus knot, in either package."""
    v, n, f = primitives.sphere(0.5, 24, 12)
    k = primitives.torus_knot(0.5, 0.2, 32, 8)
    red = mod_host.Material(color=(0.8, 0.3, 0.2), roughness=0.4)
    glow = mod_host.Material(color=(0.9, 0.6, 0.1), roughness=0.3, metalness=0.8,
                             emission_color=(1, 0.5, 0), emission_strength=2.0)
    return [mod_host.Mesh(v, n, f, red, transform=host.translation(1, 2, 3)),
            mod_host.Mesh(*k, glow)]


@pytest.mark.parametrize("bits", [None, (0, 0), (14, 10)], ids=["plain", "lossless", "14_10"])
def test_save_glb_writes_the_jax_bytes_and_loads_back_alike(bits, tmp_path, jdraco):
    kw = {} if bits is None else dict(draco=True, draco_position_bits=bits[0],
                                      draco_normal_bits=bits[1])
    ours, theirs = tmp_path / "port.glb", tmp_path / "jax.glb"
    gltf.save_glb(_meshes(host), str(ours), **kw)
    jgltf.save_glb(_meshes(jhost), str(theirs), **kw)
    assert ours.read_bytes() == theirs.read_bytes()
    got = gltf.load_gltf(str(ours), normalize=False)
    want = jgltf.load_gltf(str(ours), normalize=False)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for field in ("positions", "normals", "indices", "transform"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), field
        assert vars(g.material) == vars(w.material)
    if bits in (None, (0, 0)):  # lossless: the source arrays come back
        src = _meshes(host)[0]
        np.testing.assert_array_equal(got[0].positions, src.positions)
        np.testing.assert_array_equal(got[0].indices, np.asarray(src.indices).reshape(-1, 3))


def test_a_misdeclared_draco_primitive_raises_gltferror(tmp_path):
    """tests/test_io.py's gated variant: the stream's method byte flipped to
    edgebreaker makes the CLERS parser refuse it, as a GLTFError."""
    path = tmp_path / "draco.glb"
    v, n, f = primitives.sphere(0.5, 8, 4)
    gltf.save_glb([host.Mesh(v, n, f, host.Material())], str(path), draco=True)
    data = bytearray(path.read_bytes())
    at = data.find(b"DRACO")
    assert at > 0 and data[at + 8] == 0
    data[at + 8] = 1
    path.write_bytes(bytes(data))
    with pytest.raises(gltf.GLTFError, match="decode failed"):
        gltf.load_gltf(str(path))
    assert struct.unpack_from("<I", data, 0)[0] == 0x46546C67  # still a GLB

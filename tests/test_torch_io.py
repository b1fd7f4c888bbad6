"""Port parity: the io layer (`read_png`, `load_gltf`, `normalize_meshes`),
the CLI on a glTF scene, and the port's freedom from JAX.

  * `read_png` returns the JAX reader's bytes on the committed goldens, on
    a PNG the port writes and on a PNG with every filter type;
  * `load_gltf` gives every Mesh field of the JAX loader exactly (arrays,
    dtypes, transforms, materials) on hand-built containers, as in
    tests/test_io.py:167-301: .glb, .gltf with a data: URI and with an
    external .bin, byteStride, node matrix and TRS, a scene-less node
    tree, flat normals, the pbrMetallicRoughness mapping, normalized or not;
  * the default scene saved and loaded back compiles to the same
    SceneData, byte for byte (plain and Draco lossless);
  * `cli render --scene X.glb` at 16x16 against the JAX CLI's accumulation
    (.hdr) under the outlier rule of tests/test_trace_golden.py:60-70;
  * every port module imports in a fresh interpreter with neither `jax`
    nor `tpu_pathtracer` loaded.
"""

import base64
import json
import math
import os
import pkgutil
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import tpu_pathtracer.io as jio
import tpu_pathtracer_torch
import tpu_pathtracer_torch.io as tio
from tpu_pathtracer.io import gltf as jgltf
from tpu_pathtracer.io.image import read_png as jread_png
from tpu_pathtracer.scene.host import Material as JMaterial
from tpu_pathtracer_torch.io import gltf
from tpu_pathtracer_torch.io.image import read_png, write_png
from tpu_pathtracer_torch.scene.host import Material

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = sorted((ROOT / "tests" / "golden").glob("*.png"))


def test_io_exports_match_jax():
    assert tio.__all__ == jio.__all__


def _filtered_png(path):
    """A 5x7 RGBA PNG whose rows use filters 0-4 (None, Sub, Up, Average, Paeth)."""
    rng = np.random.default_rng(5)
    h, w = 7, 5
    raw = b"".join(bytes([y % 5]) + rng.integers(0, 256, w * 4, dtype=np.uint8).tobytes()
                   for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    Path(path).write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 6, 0, 0, 0)) + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b""))


@pytest.mark.parametrize("which", [p.name for p in GOLDEN] + ["port_written", "filters"])
def test_read_png_matches_jax(which, tmp_path):
    if which == "port_written":
        path = tmp_path / "p.png"
        img = np.random.default_rng(1).random((9, 11, 3)).astype(np.float32)
        write_png(str(path), img, flip_vertical=True)
    elif which == "filters":
        path = tmp_path / "f.png"
        _filtered_png(path)
    else:
        path = ROOT / "tests" / "golden" / which
    got, want = read_png(str(path)), jread_png(str(path))
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# glTF containers, built by hand

QUAD_POS = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
QUAD_NRM = np.tile(np.array([[0, 0, 1]], np.float32), (4, 1))
QUAD_IDX = np.array([0, 1, 2, 0, 2, 3], np.uint16)


def _views(blobs, stride=None):
    """Pack blobs into one buffer (4-byte aligned); bufferViews for each."""
    bin_data, views = b"", []
    for b in blobs:
        views.append({"buffer": 0, "byteOffset": len(bin_data), "byteLength": len(b)})
        bin_data += b + b"\x00" * (-len(b) % 4)
    if stride:
        views[0]["byteStride"] = stride
    return bin_data, views


def _gltf(case):
    """(gltf json, bin bytes) of each case."""
    accessors = [
        {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3",
         "min": [0, 0, 0], "max": [1, 1, 0]},
        {"bufferView": 1, "componentType": 5126, "count": 4, "type": "VEC3"},
        {"bufferView": 2, "componentType": 5123, "count": 6, "type": "SCALAR"},
    ]
    blobs = [QUAD_POS.tobytes(), QUAD_NRM.tobytes(), QUAD_IDX.tobytes()]
    prim = {"attributes": {"POSITION": 0, "NORMAL": 1}, "indices": 2, "mode": 4}
    nodes = [{"mesh": 0}]
    extra = {}
    stride = None
    if case == "interleaved":  # positions and normals in one view, 24-byte stride
        inter = np.concatenate([QUAD_POS, QUAD_NRM], axis=1)
        blobs = [inter.tobytes(), QUAD_IDX.astype(np.uint32).tobytes()]
        stride = 24
        accessors = [
            {"bufferView": 0, "componentType": 5126, "count": 4, "type": "VEC3"},
            {"bufferView": 0, "byteOffset": 12, "componentType": 5126, "count": 4,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5125, "count": 6, "type": "SCALAR"},
        ]
    elif case == "soup_without_normals":  # non-indexed, flat normals computed
        blobs = [QUAD_POS[QUAD_IDX].tobytes()]
        accessors = [{"bufferView": 0, "componentType": 5126, "count": 6, "type": "VEC3"}]
        prim = {"attributes": {"POSITION": 0}, "mode": 4}
    elif case == "material":
        extra["materials"] = [{
            "pbrMetallicRoughness": {"baseColorFactor": [0.5, 0.25, 0.125, 1.0],
                                     "metallicFactor": 0.75, "roughnessFactor": 0.3},
            "emissiveFactor": [1.0, 0.5, 0.0],
            "extensions": {"KHR_materials_emissive_strength": {"emissiveStrength": 3.5}},
        }]
        prim["material"] = 0
    elif case == "trs_and_matrix":  # a TRS parent over a matrix child over the mesh
        c, s = math.cos(0.3), math.sin(0.3)
        nodes = [{"children": [1], "translation": [10, 3, -2], "scale": [4, 2, 3],
                  "rotation": [0.0, math.sin(0.35), 0.0, math.cos(0.35)]},
                 {"children": [2], "matrix": [c, 0, -s, 0, 0, 1, 0, 0, s, 0, c, 0,
                                              0.5, 0.25, 0.125, 1]},
                 {"mesh": 0}]
    elif case == "no_scenes":  # roots are the nodes no node claims as a child
        nodes = [{"mesh": 0}, {"children": [0], "translation": [5, 0, 0]}]
    bin_data, views = _views(blobs, stride)
    doc = {"asset": {"version": "2.0"}, "nodes": nodes, "meshes": [{"primitives": [prim]}],
           "accessors": accessors, "bufferViews": views,
           "buffers": [{"byteLength": len(bin_data)}], **extra}
    if case != "no_scenes":
        doc.update(scene=0, scenes=[{"nodes": [0]}])
    return doc, bin_data


CONTAINERS = {
    "glb": "basic", "glb_interleaved": "interleaved", "glb_soup": "soup_without_normals",
    "glb_material": "material", "glb_trs_and_matrix": "trs_and_matrix",
    "glb_no_scenes": "no_scenes", "gltf_data_uri": "trs_and_matrix",
    "gltf_external_bin": "material",
}


def _write(tmp_path, container):
    doc, bin_data = _gltf(CONTAINERS[container])
    if container == "gltf_data_uri":
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(bin_data).decode())
        path = tmp_path / "m.gltf"
        path.write_text(json.dumps(doc))
        return str(path)
    if container == "gltf_external_bin":
        (tmp_path / "m.bin").write_bytes(bin_data)
        doc["buffers"][0]["uri"] = "m.bin"
        path = tmp_path / "m.gltf"
        path.write_text(json.dumps(doc))
        return str(path)
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    path = tmp_path / "m.glb"
    path.write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(bin_data))
                     + struct.pack("<II", len(js), 0x4E4F534A) + js
                     + struct.pack("<II", len(bin_data), 0x004E4942) + bin_data)
    return str(path)


def _assert_same_meshes(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for field in ("positions", "normals", "indices", "transform"):
            a, b = getattr(g, field), getattr(w, field)
            assert a.dtype == b.dtype and a.shape == b.shape, field
            assert a.tobytes() == b.tobytes(), field
        assert vars(g.material) == vars(w.material) and g.visible == w.visible


@pytest.mark.parametrize("normalize", [False, True], ids=["raw", "normalized"])
@pytest.mark.parametrize("container", sorted(CONTAINERS))
def test_load_gltf_matches_jax(container, normalize, tmp_path):
    path = _write(tmp_path, container)
    got = gltf.load_gltf(path, normalize=normalize)
    _assert_same_meshes(got, jgltf.load_gltf(path, normalize=normalize))
    if normalize:
        m = got[0]
        world = m.positions @ m.transform[:3, :3].T + m.transform[:3, 3]
        assert abs((world.max(0) - world.min(0)).max() - 1.0) < 1e-6
        assert abs(world.min(0)[1]) < 1e-6


def test_material_override_and_normalize_meshes_match_jax(tmp_path):
    path = _write(tmp_path, "glb_trs_and_matrix")
    white = Material(color=(1, 1, 1))
    got = gltf.load_gltf(path, material_override=white, normalize=False)
    assert got[0].material is white
    want = jgltf.load_gltf(path, material_override=JMaterial(color=(1, 1, 1)), normalize=False)
    _assert_same_meshes(gltf.normalize_meshes(got), jgltf.normalize_meshes(want))


def test_unsupported_containers_raise_gltferror(tmp_path):
    path = tmp_path / "v1.glb"
    path.write_bytes(struct.pack("<III", 0x46546C67, 1, 12))
    with pytest.raises(gltf.GLTFError, match="version"):
        gltf.load_gltf(str(path))
    doc, _ = _gltf("basic")
    path = tmp_path / "nobin.gltf"
    path.write_text(json.dumps(doc))  # a buffer without uri, outside a GLB
    with pytest.raises(gltf.GLTFError, match="BIN"):
        gltf.load_gltf(str(path))


# ---------------------------------------------------------------------------
# the CLI on a glTF scene


def _outlier_rule(a, b, mean_tol=1e-4, outlier_frac=0.01, outlier_tol=0.05):
    diff = np.abs(a - b)
    outlier = diff.max(axis=-1) > outlier_tol
    assert outlier.mean() < outlier_frac, f"outlier fraction {outlier.mean():.4f}"
    if (~outlier).any():
        assert diff[~outlier].mean() < mean_tol, f"non-outlier mean {diff[~outlier].mean():.6f}"


def test_cli_render_of_a_glb_matches_the_jax_cli(tmp_path):
    """`export` the default scene with each CLI (equal bytes), then `render
    --scene` it at 16x16 (normalized, as the CLIs load it) with each; the
    linear accumulations agree under the outlier rule."""
    from tpu_pathtracer.cli import main as jmain
    from tpu_pathtracer.io.hdr import read_hdr
    from tpu_pathtracer_torch.cli import main

    ours, theirs = tmp_path / "port.glb", tmp_path / "jax.glb"
    assert main(["export", "-o", str(ours)]) == 0
    assert jmain(["export", "-o", str(theirs)]) == 0
    assert ours.read_bytes() == theirs.read_bytes()
    args = ["render", "--scene", str(ours), "--width", "16", "--height", "16", "--frames", "2",
            "--bounces", "2", "--no-denoise", "--look-at", "0", "0.3", "0"]
    assert main(args + ["-o", str(tmp_path / "port.hdr"), "--device", "cpu"]) == 0
    assert jmain(args + ["-o", str(tmp_path / "jax.hdr")]) == 0
    got, want = read_hdr(str(tmp_path / "port.hdr")), read_hdr(str(tmp_path / "jax.hdr"))
    assert got.shape == (16, 16, 3) and np.isfinite(got).all() and got.max() > 0
    _outlier_rule(got, want)


# ---------------------------------------------------------------------------
# no JAX in the port


def test_port_imports_no_jax():
    """Import every module of the port in a fresh interpreter: neither `jax`
    nor the JAX package may be loaded."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        tpu_pathtracer_torch.__path__, "tpu_pathtracer_torch."))
    assert {"tpu_pathtracer_torch.io.draco", "tpu_pathtracer_torch.io.gltf",
            "tpu_pathtracer_torch.utils.orbit", "tpu_pathtracer_torch.viewer.session",
            "tpu_pathtracer_torch.viewer.server", "tpu_pathtracer_torch.viewer.page",
            "tpu_pathtracer_torch.ops.wavefront", "tpu_pathtracer_torch.utils.debug",
            "tpu_pathtracer_torch.utils.compcache"} <= set(names)
    code = ("import importlib, sys\n"
            f"for name in {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'tpu_pathtracer'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]


@pytest.mark.parametrize("draco", [False, True], ids=["plain", "draco_lossless"])
def test_a_saved_scene_compiles_to_the_same_scene_data(draco, tmp_path):
    """The default scene through `save_glb` and `load_gltf(normalize=False)`
    compiles to the procedural scene's SceneData, every tensor byte for
    byte: a GLB frame is the procedural frame."""
    import dataclasses

    import tpu_pathtracer_torch as tpt
    from tpu_pathtracer_torch.scene.envmap import gradient_sky

    proc = tpt.default_scene(gradient_sky(8, 16))
    path = tmp_path / "s.glb"
    gltf.save_glb(proc.meshes, str(path), draco=draco, draco_position_bits=0,
                  draco_normal_bits=0)
    scene = tpt.Scene()
    for m in gltf.load_gltf(str(path), normalize=False):
        scene.add(m)
    scene.set_environment(proc.env_radiance)

    def tensors(x, name="data"):
        if isinstance(x, torch.Tensor):
            yield name, x
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                yield from tensors(getattr(x, f.name), f"{name}.{f.name}")

    want = dict(tensors(proc.compile(device="cpu")))
    got = dict(tensors(scene.compile(device="cpu")))
    assert got.keys() == want.keys()
    for name, x in want.items():
        y = got[name]
        assert (y.dtype, y.shape, y.stride()) == (x.dtype, x.shape, x.stride()), name
        assert y.numpy().tobytes() == x.numpy().tobytes(), name

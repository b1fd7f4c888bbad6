"""glTF 2.0 mesh import and export (.glb binary and .gltf JSON containers).

The port of `tpu_pathtracer.io.gltf` (the reference's three.js GLTFLoader
import path, src/main.ts:246-302): load a user model, normalize it to unit
scale sitting on the ground plane, and optionally override all materials.

Supported: node hierarchies with matrix/TRS transforms, indexed and
non-indexed TRIANGLES primitives, POSITION/NORMAL attributes (flat normals
computed when absent), interleaved bufferViews (byteStride), data: URIs,
external .bin files, pbrMetallicRoughness -> Material mapping.

KHR_draco_mesh_compression primitives decode through the native codec
(`io.draco`, over csrc/draco_codec.cpp): sequential and edgebreaker
connectivity, raw, quantized and rANS-coded values.  Streams outside that
subset raise GLTFError with a decode-offline message.
`save_glb(..., draco=True)` writes Draco-compressed GLBs.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import List, Optional

import numpy as np

from ..scene.host import Material, Mesh
from . import draco as _draco

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class GLTFError(ValueError):
    pass


def _load_container(path: str):
    """Returns (gltf_json_dict, [buffer_bytes, ...])."""
    with open(path, "rb") as f:
        data = f.read()
    base_dir = os.path.dirname(os.path.abspath(path))

    if data[:4] == b"glTF":  # GLB
        magic, version, _length = struct.unpack_from("<III", data, 0)
        if version != 2:
            raise GLTFError(f"unsupported GLB version {version}")
        pos = 12
        gltf = None
        bin_chunk = None
        while pos < len(data):
            clen, ctype = struct.unpack_from("<II", data, pos)
            chunk = data[pos + 8 : pos + 8 + clen]
            if ctype == 0x4E4F534A:  # 'JSON'
                gltf = json.loads(chunk)
            elif ctype == 0x004E4942:  # 'BIN\0'
                bin_chunk = chunk
            pos += 8 + clen + (-clen % 4)
        if gltf is None:
            raise GLTFError("GLB missing JSON chunk")
    else:
        gltf = json.loads(data)
        bin_chunk = None

    buffers = []
    for buf in gltf.get("buffers", []):
        uri = buf.get("uri")
        if uri is None:
            if bin_chunk is None:
                raise GLTFError("buffer without uri and no GLB BIN chunk")
            buffers.append(bin_chunk)
        elif uri.startswith("data:"):
            buffers.append(base64.b64decode(uri.split(",", 1)[1]))
        else:
            with open(os.path.join(base_dir, uri), "rb") as f:
                buffers.append(f.read())
    return gltf, buffers


def _read_accessor(gltf, buffers, index: int) -> np.ndarray:
    acc = gltf["accessors"][index]
    if "sparse" in acc:
        raise GLTFError("sparse accessors not supported")
    n_comp = _TYPE_COUNTS[acc["type"]]
    dtype = np.dtype(_COMPONENT_DTYPES[acc["componentType"]])
    count = acc["count"]

    if "bufferView" not in acc:
        return np.zeros((count, n_comp), dtype)
    bv = gltf["bufferViews"][acc["bufferView"]]
    buf = buffers[bv["buffer"]]
    offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = bv.get("byteStride") or n_comp * dtype.itemsize

    if stride == n_comp * dtype.itemsize:
        out = np.frombuffer(buf, dtype, count=count * n_comp, offset=offset)
        out = out.reshape(count, n_comp)
    else:  # interleaved
        raw = np.frombuffer(
            buf, np.uint8, count=(count - 1) * stride + n_comp * dtype.itemsize,
            offset=offset,
        )
        strided = np.lib.stride_tricks.as_strided(
            raw, shape=(count, n_comp * dtype.itemsize), strides=(stride, 1)
        )
        out = strided.copy().view(dtype).reshape(count, n_comp)
    return out


def _node_matrix(node) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T  # column-major
    m = np.eye(4)
    if "translation" in node:
        m[:3, 3] = node["translation"]
    if "rotation" in node:  # xyzw quaternion
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
            ]
        )
        m[:3, :3] = m[:3, :3] @ r
    if "scale" in node:
        m[:3, :3] = m[:3, :3] @ np.diag(node["scale"])
    return m


def _material_from_gltf(mat_def) -> Material:
    pbr = mat_def.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1, 1, 1, 1])
    emissive = mat_def.get("emissiveFactor", [0, 0, 0])
    strength = mat_def.get("extensions", {}).get(
        "KHR_materials_emissive_strength", {}
    ).get("emissiveStrength", 1.0)
    has_emission = any(c > 0 for c in emissive)
    return Material(
        color=tuple(base[:3]),
        specular_color=(1.0, 1.0, 1.0),
        roughness=float(pbr.get("roughnessFactor", 1.0)),
        metalness=float(pbr.get("metallicFactor", 1.0)),
        emission_color=tuple(emissive),
        emission_strength=float(strength) if has_emission else 0.0,
    )


def _flat_normals(pos: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Per-vertex normals from area-weighted face normals (for meshes that
    ship without NORMAL, mirroring three.js computeVertexNormals)."""
    p = pos[idx.reshape(-1, 3)]
    fn = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    normals = np.zeros_like(pos)
    for k in range(3):
        np.add.at(normals, idx.reshape(-1, 3)[:, k], fn)
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(norm, 1e-20)


def load_gltf(
    path: str,
    *,
    material_override: Optional[Material] = None,
    normalize: bool = True,
) -> List[Mesh]:
    """Load a .glb/.gltf file into a list of world-transformed Meshes.

    With `normalize=True` the combined model is uniformly scaled to unit
    maximum extent, centered in x/z, and lifted so its base sits at y=0 —
    the reference's drop-in normalization (src/main.ts:268-279, which centers
    at y=0.5 for a unit model: here base-at-ground is the equivalent since
    extents vary).  `material_override` mirrors the reference forcing all
    imported materials to its `white` material (src/main.ts:277-279).
    """
    gltf, buffers = _load_container(path)

    meshes: List[Mesh] = []

    def read_draco_primitive(prim):
        """Decode a KHR_draco_mesh_compression primitive -> (pos, nrm, idx)."""
        ext = prim["extensions"]["KHR_draco_mesh_compression"]
        bv = gltf["bufferViews"][ext["bufferView"]]
        off = bv.get("byteOffset", 0)
        blob = bytes(buffers[bv["buffer"]][off : off + bv["byteLength"]])
        try:
            dec = _draco.decode(blob)
        except _draco.DracoError as e:
            raise GLTFError(
                f"Draco primitive decode failed: {e}. Unsupported Draco "
                "variants can be decoded offline, e.g. `gltf-pipeline -i "
                "model.glb -o out.glb -d`"
            ) from e
        by_id = {a["unique_id"]: a for a in dec["attributes"]}
        amap = ext.get("attributes", {})
        if "POSITION" not in amap or amap["POSITION"] not in by_id:
            raise GLTFError("Draco primitive missing POSITION attribute")
        if by_id[amap["POSITION"]]["components"] != 3:
            raise GLTFError(
                "Draco POSITION attribute must have 3 components, got "
                f"{by_id[amap['POSITION']]['components']}"
            )
        pos = np.asarray(by_id[amap["POSITION"]]["values"], np.float32)
        idx = dec["indices"].astype(np.int64)
        if "NORMAL" in amap and amap["NORMAL"] in by_id:
            if by_id[amap["NORMAL"]]["components"] != 3:
                raise GLTFError(
                    "Draco NORMAL attribute must have 3 components, got "
                    f"{by_id[amap['NORMAL']]['components']}"
                )
            nrm = np.asarray(by_id[amap["NORMAL"]]["values"], np.float32)
        else:
            nrm = _flat_normals(pos, idx)
        return pos, nrm, idx

    def emit_primitive(prim, world: np.ndarray):
        if prim.get("mode", 4) != 4:  # TRIANGLES only
            return
        if "extensions" in prim and "KHR_draco_mesh_compression" in prim["extensions"]:
            pos, nrm, idx = read_draco_primitive(prim)
            mat = (material_override if material_override is not None
                   else _material_from_gltf(gltf["materials"][prim["material"]])
                   if "material" in prim else Material())
            meshes.append(Mesh(pos, nrm, idx, mat, transform=world))
            return
        attrs = prim["attributes"]
        pos = _read_accessor(gltf, buffers, attrs["POSITION"]).astype(np.float32)
        if "indices" in prim:
            idx = _read_accessor(gltf, buffers, prim["indices"]).reshape(-1)
        else:
            idx = np.arange(len(pos), dtype=np.uint32)
        idx = idx.astype(np.int64).reshape(-1, 3)
        if "NORMAL" in attrs:
            nrm = _read_accessor(gltf, buffers, attrs["NORMAL"]).astype(np.float32)
        else:
            nrm = _flat_normals(pos, idx)
        if material_override is not None:
            mat = material_override
        elif "material" in prim:
            mat = _material_from_gltf(gltf["materials"][prim["material"]])
        else:
            mat = Material()
        meshes.append(Mesh(pos, nrm, idx, mat, transform=world))

    def walk(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            for prim in gltf["meshes"][node["mesh"]]["primitives"]:
                emit_primitive(prim, world)
        for child in node.get("children", []):
            walk(child, parent=world)

    all_nodes = gltf.get("nodes", [])
    if "scenes" in gltf:
        scene_def = gltf["scenes"][gltf.get("scene", 0)]
        roots = scene_def.get("nodes", [])
    else:
        # no scene: roots are the nodes that no other node claims as a child
        children = {c for n in all_nodes for c in n.get("children", [])}
        roots = [i for i in range(len(all_nodes)) if i not in children]
    for r in roots:
        walk(r, parent=np.eye(4))

    if normalize and meshes:
        meshes[:] = normalize_meshes(meshes)
    return meshes


def normalize_meshes(meshes: List[Mesh]) -> List[Mesh]:
    """Uniform-scale the model to unit max extent, center x/z, base at y=0
    (the reference's import normalization, src/main.ts:268-276)."""
    mins = np.full(3, np.inf)
    maxs = np.full(3, -np.inf)
    for m in meshes:
        world_pos = m.positions @ np.asarray(m.transform[:3, :3]).T + m.transform[:3, 3]
        mins = np.minimum(mins, world_pos.min(axis=0))
        maxs = np.maximum(maxs, world_pos.max(axis=0))
    extent = float((maxs - mins).max())
    scale = 1.0 / extent if extent > 0 else 1.0
    center = (mins + maxs) / 2.0

    fix = np.eye(4)
    fix[:3, :3] *= scale
    fix[:3, 3] = (
        -center[0] * scale,
        -mins[1] * scale,
        -center[2] * scale,
    )
    return [
        Mesh(m.positions, m.normals, m.indices, m.material, transform=fix @ m.transform)
        for m in meshes
    ]


def save_glb(
    meshes,
    path: str,
    *,
    draco: bool = False,
    draco_position_bits: int = 14,
    draco_normal_bits: int = 10,
) -> None:
    """Write meshes to a minimal glTF 2.0 binary (.glb).

    The export counterpart of `load_gltf` (the reference only imports).
    Each Mesh becomes one node+primitive with POSITION/NORMAL/indices and a
    pbrMetallicRoughness material; transforms are baked into node matrices.

    With `draco=True` geometry is compressed through the native Draco codec
    (KHR_draco_mesh_compression, sequential encoding); `*_bits` set the
    quantization depth (0 = lossless float32).
    """
    bin_data = b""
    buffer_views = []
    accessors = []

    def add_blob(arr, target):
        nonlocal bin_data
        arr = np.ascontiguousarray(arr)
        offset = len(bin_data)
        bin_data += arr.tobytes()
        bin_data += b"\x00" * (-len(bin_data) % 4)
        bv = {"buffer": 0, "byteOffset": offset, "byteLength": arr.nbytes}
        if target is not None:
            bv["target"] = target
        buffer_views.append(bv)
        return len(buffer_views) - 1

    gltf_meshes, nodes, materials = [], [], []
    for mi, m in enumerate(meshes):
        pos = np.asarray(m.positions, np.float32)
        nrm = np.asarray(m.normals, np.float32)
        idx = np.asarray(m.indices, np.uint32).reshape(-1)

        prim_ext = None
        if draco:
            blob = _draco.encode(
                pos, idx, nrm,
                position_bits=draco_position_bits,
                normal_bits=draco_normal_bits,
            )
            bv_d = add_blob(np.frombuffer(blob, np.uint8), None)
            # accessors carry only shape metadata; data lives in the Draco
            # stream (attribute ids: POSITION=0, NORMAL=1 per io/draco.py)
            accessors.append({
                "componentType": 5126, "count": len(pos), "type": "VEC3",
                "min": pos.min(0).tolist(), "max": pos.max(0).tolist(),
            })
            a_p = len(accessors) - 1
            accessors.append({"componentType": 5126, "count": len(nrm),
                              "type": "VEC3"})
            a_n = len(accessors) - 1
            accessors.append({"componentType": 5125, "count": len(idx),
                              "type": "SCALAR"})
            a_i = len(accessors) - 1
            prim_ext = {"KHR_draco_mesh_compression": {
                "bufferView": bv_d,
                "attributes": {"POSITION": 0, "NORMAL": 1},
            }}
        else:
            bv_p = add_blob(pos, 34962)
            accessors.append({
                "bufferView": bv_p, "componentType": 5126, "count": len(pos),
                "type": "VEC3", "min": pos.min(0).tolist(),
                "max": pos.max(0).tolist(),
            })
            a_p = len(accessors) - 1
            bv_n = add_blob(nrm, 34962)
            accessors.append({"bufferView": bv_n, "componentType": 5126,
                              "count": len(nrm), "type": "VEC3"})
            a_n = len(accessors) - 1
            bv_i = add_blob(idx, 34963)
            accessors.append({"bufferView": bv_i, "componentType": 5125,
                              "count": len(idx), "type": "SCALAR"})
            a_i = len(accessors) - 1

        mat = m.material
        mat_def = {
            "pbrMetallicRoughness": {
                "baseColorFactor": list(mat.color) + [1.0],
                "metallicFactor": float(mat.metalness),
                "roughnessFactor": float(mat.roughness),
            },
        }
        if mat.emission_strength > 0:
            mat_def["emissiveFactor"] = [
                min(1.0, c) for c in mat.emission_color
            ]
            mat_def["extensions"] = {"KHR_materials_emissive_strength": {
                "emissiveStrength": float(mat.emission_strength)}}
        materials.append(mat_def)

        prim = {
            "attributes": {"POSITION": a_p, "NORMAL": a_n},
            "indices": a_i, "material": mi, "mode": 4,
        }
        if prim_ext is not None:
            prim["extensions"] = prim_ext
        gltf_meshes.append({"primitives": [prim]})
        node = {"mesh": mi}
        t = np.asarray(m.transform, np.float64)
        if not np.allclose(t, np.eye(4)):
            node["matrix"] = t.T.reshape(-1).tolist()  # column-major
        nodes.append(node)

    gltf = {
        "asset": {"version": "2.0", "generator": "tpu_pathtracer"},
        "scene": 0,
        "scenes": [{"nodes": list(range(len(nodes)))}],
        "nodes": nodes,
        "meshes": gltf_meshes,
        "materials": materials,
        "accessors": accessors,
        "bufferViews": buffer_views,
        "buffers": [{"byteLength": len(bin_data)}],
    }
    ext_used = []
    if any("extensions" in m for m in materials):
        ext_used.append("KHR_materials_emissive_strength")
    if draco:
        ext_used.append("KHR_draco_mesh_compression")
        gltf["extensionsRequired"] = ["KHR_draco_mesh_compression"]
    if ext_used:
        gltf["extensionsUsed"] = ext_used

    js = json.dumps(gltf).encode()
    js += b" " * (-len(js) % 4)
    glb = (
        struct.pack("<III", 0x46546C67, 2,
                     12 + 8 + len(js) + 8 + len(bin_data))
        + struct.pack("<II", len(js), 0x4E4F534A) + js
        + struct.pack("<II", len(bin_data), 0x004E4942) + bin_data
    )
    with open(path, "wb") as f:
        f.write(glb)

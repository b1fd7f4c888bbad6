"""Port parity: the jax-free scene compile and the numpy -> torch carry-over.

tpu_pathtracer_torch builds the scene, the BVH leaf order and the
environment CDF tables with numpy alone; the results must equal the JAX
package's compile byte for byte."""

import dataclasses

import numpy as np
import pytest
import torch

import tpu_pathtracer as jpt
from tpu_pathtracer.accel.bvh import build_bvh_flat as j_build_bvh_flat
from tpu_pathtracer.accel.bvh import flat_to_links as j_flat_to_links
from tpu_pathtracer.accel.bvh import links_to_fat as j_links_to_fat
from tpu_pathtracer.scene import primitives as jprim
from tpu_pathtracer.scene.envmap import gradient_sky as j_gradient_sky
from tpu_pathtracer.scene.types import Camera as JCamera
from tpu_pathtracer.scene.types import RenderParams as JParams
import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch.accel.bvh import build_bvh_flat, flat_to_links, links_to_fat
from tpu_pathtracer_torch.scene import primitives as tprim
from tpu_pathtracer_torch.scene.convert import params_from_numpy, scene_from_numpy
from tpu_pathtracer_torch.scene.envmap import gradient_sky

GROUPS = {
    "triangles": ("p0", "p1", "p2", "n0", "n1", "n2", "material"),
    "materials": ("color", "specular_color", "roughness", "metalness",
                  "emission_color", "emission_strength"),
    "bvh": ("node_min", "node_max", "left", "right", "tri", "is_leaf"),
    "links": ("node_min", "node_max", "tri", "miss"),
    "packed": ("nodes", "tri_pos", "tri_shade", "tri_perm", "fat_nodes"),
    "env": ("radiance", "marginal_cdf", "conditional_cdf", "pdf", "sample_pdf"),
}


def jax_leaves(sd):
    """A compiled JAX scene as numpy arrays keyed "group.field"."""
    out = {}
    for group in ("triangles", "materials", "bvh", "links", "packed", "env"):
        obj = getattr(sd, group)
        for f in dataclasses.fields(obj):
            out[f"{group}.{f.name}"] = np.asarray(getattr(obj, f.name))
    return out


@pytest.fixture(scope="module")
def scenes():
    jsd = jpt.default_scene(j_gradient_sky(8, 16)).compile()
    tsd = tpt.default_scene(gradient_sky(8, 16)).compile(device="cpu")
    return jsd, tsd


def _assert_same_bytes(a: np.ndarray, b: np.ndarray, name: str):
    assert a.dtype == b.dtype and a.shape == b.shape, (name, a.dtype, b.dtype, a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_default_scene_compile_matches_jax_bytes(scenes, group):
    jsd, tsd = scenes
    for field in GROUPS[group]:
        _assert_same_bytes(getattr(getattr(tsd, group), field).numpy(),
                           np.asarray(getattr(getattr(jsd, group), field)), f"{group}.{field}")
    assert tsd.packed.tri_pos.shape == (2048, 9)  # 1998 triangles padded


def test_gradient_sky_matches_jax():
    _assert_same_bytes(gradient_sky(64, 128), j_gradient_sky(64, 128), "sky")


def test_bvh_and_links_match_jax_numpy_builder():
    rng = np.random.default_rng(0)
    p0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    p1 = p0 + rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32)
    p2 = p0 + rng.uniform(-0.1, 0.1, (300, 3)).astype(np.float32)
    flat = build_bvh_flat(p0, p1, p2)
    jflat = j_build_bvh_flat(p0, p1, p2, native=False)
    for k in jflat:
        _assert_same_bytes(flat[k], jflat[k], k)
    links, jlinks = flat_to_links(flat), j_flat_to_links(jflat, native=False)
    for k in jlinks:
        _assert_same_bytes(links[k], jlinks[k], k)
    # the fat-leaf layout, over packed rows in DFS leaf order
    order = links["tri"][links["tri"] >= 0]
    packed_id = np.where(links["tri"] >= 0, np.argsort(order)[np.clip(links["tri"], 0, None)],
                         -1).astype(np.int32)
    tri_pos = np.concatenate([p0, p1, p2], axis=1)[order]
    for max_leaf, end in ((8, None), (4, 1024)):
        _assert_same_bytes(links_to_fat(links, tri_pos, packed_id, max_leaf, end),
                           j_links_to_fat(jlinks, tri_pos, packed_id, max_leaf, end),
                           f"fat_nodes max_leaf={max_leaf}")


def test_every_jax_scene_key_has_a_port_field(scenes):
    """scene_from_numpy carries every leaf of the JAX scene, and the port's
    scene has no leaf the JAX scene lacks."""
    jsd, tsd = scenes
    from tpu_pathtracer_torch.scene.convert import leaves_to_numpy

    assert set(leaves_to_numpy(tsd)) == set(jax_leaves(jsd))
    assert set(jax_leaves(jsd)) == {f"{g}.{f}" for g, fs in GROUPS.items() for f in fs}


def test_traversal_tables_keep_their_int_columns(scenes):
    """The link columns of nodes (6-7) and fat_nodes (6-8) are int32 bit
    patterns (-1 is a NaN pattern): read through an int32 view they hold
    the JAX compile's links, and padded rows end the walk."""
    jsd, tsd = scenes
    nodes = tsd.packed.nodes[:, 6:8].contiguous().view(torch.int32).numpy()
    fat = tsd.packed.fat_nodes[:, 6:9].contiguous().view(torch.int32).numpy()
    np.testing.assert_array_equal(nodes, np.asarray(jsd.packed.nodes)[:, 6:8].view(np.int32))
    np.testing.assert_array_equal(fat, np.asarray(jsd.packed.fat_nodes)[:, 6:9].view(np.int32))
    k, k2 = nodes.shape[0], fat.shape[0]
    assert (nodes[:, 0] >= -1).all() and (nodes[:, 0] < 2048).all() and (nodes[:, 1] <= k).all()
    assert (fat[:, 0] <= k2).all() and (fat[:, 2] <= 8).all() and (fat[:, 2] >= 0).all()
    pad = np.isinf(tsd.packed.fat_nodes[:, 0].numpy())  # the inverted boxes of padded rows
    assert pad.any() and (fat[pad, 2] == 0).all() and (fat[pad, 0] == k2).all()


def test_scene_from_numpy_roundtrip(scenes):
    jsd, tsd = scenes
    carried = scene_from_numpy(jax_leaves(jsd), device="cpu")
    for group, fields in GROUPS.items():
        for field in fields:
            _assert_same_bytes(getattr(getattr(carried, group), field).numpy(),
                               getattr(getattr(tsd, group), field).numpy(), f"{group}.{field}")


def test_scene_from_numpy_carries_a_large_scene():
    """A JAX scene past 8,192 triangles (the streamed kernel's path) crosses
    to the port byte-equal to the port's own compile."""
    js = jpt.Scene()
    js.add(jpt.Mesh(*jprim.sphere(1.0, 80, 60), jpt.Material(color=(0.8, 0.7, 0.6))))
    ts = tpt.Scene()
    ts.add(tpt.Mesh(*tprim.sphere(1.0, 80, 60), tpt.Material(color=(0.8, 0.7, 0.6))))
    carried = scene_from_numpy(jax_leaves(js.compile()), device="cpu")
    tsd = ts.compile(device="cpu")
    assert carried.packed.tri_pos.shape == (16384, 9)
    for group, fields in GROUPS.items():
        for field in fields:
            _assert_same_bytes(getattr(getattr(carried, group), field).numpy(),
                               getattr(getattr(tsd, group), field).numpy(), f"{group}.{field}")


def test_params_from_numpy_roundtrip():
    cam = JCamera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45, aperture=0.05)
    jp = JParams.create(cam, frame=7, env_intensity=1.5, env_rotation=0.25)
    arrays = {f"camera.{f.name}": np.asarray(getattr(cam, f.name))
              for f in dataclasses.fields(cam)}
    arrays.update(frame=np.asarray(jp.frame), env_intensity=np.asarray(jp.env_intensity),
                  env_rotation=np.asarray(jp.env_rotation))
    tp = params_from_numpy(arrays, device="cpu")
    native = tpt.RenderParams.create(
        tpt.Camera.create(position=(0, 1, 4), look_at=(0, 0.5, 0), fov=45, aperture=0.05),
        frame=7, env_intensity=1.5, env_rotation=0.25)
    assert tp.frame == native.frame == 7
    for f in dataclasses.fields(tp.camera):
        _assert_same_bytes(getattr(tp.camera, f.name).numpy(),
                           getattr(native.camera, f.name).numpy(), f.name)
    for name in ("env_intensity", "env_rotation"):
        _assert_same_bytes(getattr(tp, name).numpy(), getattr(native, name).numpy(), name)


def test_scene_to_device_keeps_values(scenes):
    _, tsd = scenes
    moved = tsd.to(torch.device("cpu"))
    assert moved is not tsd
    assert torch.equal(moved.packed.tri_pos, tsd.packed.tri_pos)

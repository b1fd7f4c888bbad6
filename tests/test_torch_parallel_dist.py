"""The sharding layer's collectives: one spawn of 4 gloo ranks on the CPU.

The ranks run `torch_parallel_ranks.checks_suite` (32x32, 2 bounces, the default
scene, TPT_SORT_WINDOW=32 so that every band sorts in 8 or more windows)
through `dryrun.run`, which joins them through a file store under the
test's temporary directory, within 120 s.  Each test reads the ranks'
saved results and holds them against the unsharded functions run here:

  * the 2x2 step equals the in-process composite of its mesh positions'
    frames, and 4 tiles equal the unsharded frame, bit for bit;
  * the sharded loss and gradients over 4 tiles equal the unsharded
    `make_param_loss` ones (loss rtol 1e-5, gradients atol 1e-6 / rtol
    1e-4), counted once, not 4 times, and 3 steps of `invert_sharded`
    equal 3 of `diff.invert` (losses and colors rtol 1e-4, colors atol
    1e-6, as the port's invert is held to optax's);
  * `render_all` equals the frames stepped one by one, and
    `Renderer(shard=ShardConfig(2, 2)).render_all()` the accumulation of
    the composites, with JAX's chunked progress and checkpoint schedule;
  * `fetch_rows` / `host_local_target`, `replicate` (each rank's own
    camera becomes rank 0's), `bench_scaling`'s
    rows for tiles 1, 2 and 4, mesh validation, and `dryrun_multichip(4)`'s
    body."""

import numpy as np
import pytest
import torch

import tpu_pathtracer_torch as tpt
from tpu_pathtracer_torch import diff
from tpu_pathtracer_torch.ops import trace as ttrace
from tpu_pathtracer_torch.parallel import dryrun
from tpu_pathtracer_torch.parallel.sharded import shard_frame
import torch_parallel_ranks as suite

W = H = 32
BOUNCES = 2
WINDOW = "32"
SPEC = {"device": "cpu", "width": W, "height": H, "bounces": BOUNCES,
        "env": {"TPT_SORT_WINDOW": WINDOW}}
KW = dict(width=W, height=H, aspect=1.0, max_bounces=BOUNCES)


@pytest.fixture(scope="module")
def out_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


@pytest.fixture(scope="module")
def ranks(out_dir):
    return dryrun.run(suite.checks_suite, 4, dict(SPEC, checkpoint=str(out_dir / "ckpt.npz")),
                      out_dir, timeout=120.0)


@pytest.fixture(scope="module")
def scene():
    return dryrun.tiny_scene("cpu")


@pytest.fixture
def window(monkeypatch):
    monkeypatch.setenv("TPT_SORT_WINDOW", WINDOW)


def _params(cam, frame=1):
    return tpt.RenderParams.create(cam, frame=frame)


def composite(scene, params):
    """The 2x2 mesh's frame at 2 samples put together in process: each
    tile's band, the mean of its two sample shards' frames."""
    bands = []
    for t in range(2):
        s0, s1 = (shard_frame(scene, params, tile=t, sample=s, tiles=2, samples=2,
                              samples_per_frame=2, **KW) for s in range(2))
        bands.append((s0 + s1) / 2.0)
    return torch.cat(bands)


def _same_on_every_rank(ranks, key):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[key], ranks[0][key], err_msg=key)
    return ranks[0][key]


def test_2x2_step_equals_the_in_process_composite(ranks, scene, window):
    got = _same_on_every_rank(ranks, "step_2x2")
    want = composite(scene[0], _params(scene[1])).numpy()
    np.testing.assert_array_equal(got, want)


def test_4_tiles_equal_the_unsharded_frame(ranks, scene, window):
    got = _same_on_every_rank(ranks, "step_4x1")
    want = ttrace.render_frame(scene[0], _params(scene[1]), **KW).numpy()
    np.testing.assert_array_equal(got, want)


def test_sharded_grads_match_unsharded(ranks, scene):
    """The one all-reduce over the tiles gives the unsharded loss and
    gradients; a second reduction (or DDP's mean) would not."""
    data, cam = scene
    paths = list(suite.GRAD_PATHS)
    target = torch.from_numpy(ranks[0]["vg_target"])
    params = _params(cam)
    loss_p = diff.make_param_loss(diff.make_loss(target, **KW), data, params, paths)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in diff.extract(data, params, paths).items()}
    l_ref = loss_p(leaves)
    g_ref = dict(zip(paths, torch.autograd.grad(l_ref, list(leaves.values()))))
    for r in ranks:
        np.testing.assert_allclose(float(r["vg_loss"]), float(l_ref.detach()), rtol=1e-5)
        for p in paths:
            got, want = r[f"vg_grad:{p}"], g_ref[p].numpy()
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-4, err_msg=p)
            assert np.abs(want).max() > 1e-4
            assert not np.allclose(got, 4 * want, atol=1e-6, rtol=1e-4), p


def test_invert_sharded_matches_invert(ranks, scene):
    """3 Adam steps on the all-reduced gradients take the same path as 3
    on the unsharded ones, on every rank."""
    data, cam = scene
    target = diff.render_frame_diff(data, _params(cam), **KW).detach()
    want = diff.invert(suite.wrong_colors(data), _params(cam), target, ["materials.color"],
                       **suite.INVERT, **KW)
    assert want.losses[-1] < want.losses[0]
    for r in ranks:
        np.testing.assert_allclose(r["invert_losses"], want.losses, rtol=1e-4)
        np.testing.assert_allclose(r["invert_color"], want.values["materials.color"].numpy(),
                                   rtol=1e-4, atol=1e-6)


def test_render_all_matches_stepwise(ranks):
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "render_all"),
                                  _same_on_every_rank(ranks, "stepwise"))


def test_sharded_renderer_accumulates_the_composites(ranks, scene, window):
    """Renderer(shard=ShardConfig(2, 2)) over 2 frames of 2 samples: the
    running mean of the 2x2 composites, one progress event (one chunk of
    min(2, 32) frames), and a finite display image of the whole frame."""
    acc = torch.zeros((H, W, 3))
    for f in (1, 2):
        ttrace.accumulate(acc, composite(scene[0], _params(scene[1], f)), f, out=acc)
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "renderer_acc"), acc.numpy())
    np.testing.assert_array_equal(ranks[0]["renderer_progress"], [1.0])
    disp = _same_on_every_rank(ranks, "renderer_display")
    assert disp.shape == (H, W, 3) and np.isfinite(disp).all()


def test_sharded_render_all_chunks_progress_and_checkpoints(ranks, out_dir):
    """5 frames on 4 tiles with checkpoint_every=2: progress and a
    checkpoint after frames 2, 4 and 5 (chunks of 2, 2 and 1), one more
    checkpoint at the end, as JAX's sharded render_all; rank 0's file
    holds the whole accumulation."""
    for r in ranks:
        np.testing.assert_allclose(r["chunked_progress"], [3 / 6, 5 / 6, 6 / 6])
        assert r["chunked_saves"].tolist() == [3, 5, 6, 6]
    ckpt = np.load(out_dir / "ckpt.npz")
    assert int(ckpt["frame"]) == 6 and int(ckpt["frames"]) == 5
    np.testing.assert_array_equal(ckpt["acc"], _same_on_every_rank(ranks, "chunked_acc"))


def test_fetch_rows_and_host_local_target(ranks):
    full = np.arange(H * W * 3, dtype=np.float32).reshape(H, W, 3)
    present = np.stack([r["fetch_present"] for r in ranks])
    assert (present.sum(axis=0) == 1).all(), "each row on exactly one rank"
    for i, r in enumerate(ranks):
        rows = slice(*r["target_rows"])
        assert (rows.start, rows.stop) == (8 * i, 8 * i + 8)
        assert r["fetch_present"][rows].all() and r["fetch_present"].sum() == 8
        np.testing.assert_array_equal(r["fetch_data"][rows], full[rows])
        assert not r["fetch_data"][~r["fetch_present"]].any()
    np.testing.assert_array_equal(sum(r["fetch_data"] for r in ranks), full)
    np.testing.assert_array_equal(_same_on_every_rank(ranks, "replicated_position"),
                                  [0.0, 1.0, 4.0])


def test_bench_scaling_has_rows_for_tiles_1_2_4(ranks):
    rows = _same_on_every_rank(ranks, "scaling")
    assert rows[:, 0].tolist() == [1, 2, 4]  # tiles=8 skipped: 4 ranks
    assert np.isfinite(rows[:, 1]).all() and (rows[:, 1] > 0).all()
    assert rows[0, 2] == 1.0


def test_mesh_validation_across_ranks(ranks):
    assert list(_same_on_every_rank(ranks, "validation_errors")) == [
        "mesh (5x1) needs 5 ranks, have 4", "height 6 must divide by tile axis 4"]


def test_dryrun_multichip_body(ranks):
    """What each rank of `dryrun_multichip(4)` runs: a (2, 2) step on an
    8x16 image and a value_and_grad over 4 tiles, finite, equal on every
    rank."""
    assert _same_on_every_rank(ranks, "dryrun_mesh").tolist() == [2, 2]
    img = _same_on_every_rank(ranks, "dryrun_image")
    assert img.shape == (8, 16, 3) and np.isfinite(img).all()
    assert np.isfinite(_same_on_every_rank(ranks, "dryrun_loss"))
    assert np.isfinite(_same_on_every_rank(ranks, "dryrun_grad")).all()

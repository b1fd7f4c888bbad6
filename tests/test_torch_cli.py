"""The port's CLI (`python -m tpu_pathtracer_torch.cli`) with `--device cpu`,
mirroring tests/test_cli.py (info, render with checkpoint and resume, a
scaled render, benchmark, invert, view, export, a glTF scene), and its
numpy codecs held byte for byte to the JAX package's: the Radiance HDR
writer and reader, and the sun-sky environment."""

import json
import time
import urllib.request

import numpy as np
import pytest
import torch

from tpu_pathtracer.io import hdr as jhdr
from tpu_pathtracer.io.image import read_png
from tpu_pathtracer.scene import sky as jsky
from tpu_pathtracer_torch.cli import main
from tpu_pathtracer_torch.io import hdr
from tpu_pathtracer_torch.io.gltf import load_gltf
from tpu_pathtracer_torch.scene import sky

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread for these tests' many small ops: under the
    suite's parallel workers, torch's default pool (a thread a core in
    each worker) oversubscribes the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_info(capsys):
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert "torch" in out and "cuda available" in out


def test_cli_render_checkpoint_resume(tmp_path):
    png = str(tmp_path / "r.png")
    ckpt = str(tmp_path / "c.npz")
    args = ["render", "--width", "24", "--height", "24", "--frames", "2",
            "--bounces", "1", "--no-denoise", "--tonemap", "aces", *CPU]
    assert main(args + ["-o", png, "--checkpoint", ckpt, "--timing"]) == 0
    assert read_png(png).shape[:2] == (24, 24)

    # resume to 4 frames must equal a fresh 4-frame render
    png_resumed = str(tmp_path / "r4a.png")
    args4 = ["render", "--width", "24", "--height", "24", "--frames", "4",
             "--bounces", "1", "--no-denoise", "--tonemap", "aces", *CPU]
    assert main(args4 + ["-o", png_resumed, "--resume", ckpt]) == 0
    png_fresh = str(tmp_path / "r4b.png")
    assert main(args4 + ["-o", png_fresh]) == 0
    np.testing.assert_array_equal(read_png(png_resumed), read_png(png_fresh))


def test_cli_render_checkpoint_every_and_metrics(tmp_path):
    ckpt = str(tmp_path / "c.npz")
    metrics = tmp_path / "m.jsonl"
    assert main(["render", "--width", "16", "--height", "16", "--frames", "3", "--bounces", "1",
                 "--no-denoise", "-o", str(tmp_path / "r.png"), "--checkpoint", ckpt,
                 "--checkpoint-every", "2", "--metrics", str(metrics), *CPU]) == 0
    assert int(np.load(ckpt)["frame"]) == 4
    events = [json.loads(x)["event"] for x in metrics.read_text().splitlines()]
    assert events.count("progress") == 3 and "complete" in events


def test_cli_render_scaled(tmp_path):
    png = str(tmp_path / "s.png")
    assert main(["render", "--width", "32", "--height", "32", "--scale", "0.5",
                 "--frames", "1", "--bounces", "1", "--no-denoise", "-o", png, *CPU]) == 0
    assert read_png(png).shape[:2] == (32, 32)  # upscaled to display res


def test_cli_render_sky_to_hdr(tmp_path):
    out = str(tmp_path / "s.hdr")
    assert main(["render", "--width", "16", "--height", "8", "--frames", "1", "--bounces", "1",
                 "--env", "sky:elevation=30", "-o", out, *CPU]) == 0
    img = hdr.read_hdr(out)
    assert img.shape == (8, 16, 3) and np.isfinite(img).all() and img.max() > 0


def test_cli_benchmark(capsys):
    assert main(["benchmark", "--width", "16", "--height", "16",
                 "--frames", "2", "--bounces", "1", "--reps", "1", *CPU]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["unit"] == "rays/s" and rec["value"] > 0
    assert rec["metric"] == "ray_scene_intersections_per_s_cpu"
    assert "device_per_frame_ms" not in rec  # no device activity off the card


def test_cli_invert(capsys):
    assert main(["invert", "--width", "10", "--height", "10", "--bounces", "2",
                 "--steps", "25", "--lr", "0.1", *CPU]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["value"] < rec["loss_start"]


def test_cli_shard_joins_with_the_rank_device(monkeypatch, tmp_path):
    """`render --shard-tiles 2 --device cpu` under torchrun's environment
    joins with gloo even where a card is present: the CLI hands its
    device to `multihost.initialize` (CUDA stubbed, the group's start
    recorded and stopped there)."""
    import torch.distributed as dist

    class Joined(Exception):
        pass

    def join(backend, **kw):
        raise Joined(backend)

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", join)
    monkeypatch.setattr("torch.cuda.is_available", lambda: True)
    monkeypatch.setattr("torch.cuda.device_count", lambda: 1)
    for k, v in dict(WORLD_SIZE="2", RANK="0", LOCAL_RANK="0", LOCAL_WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(Joined, match="gloo"):
        main(["render", "--shard-tiles", "2", "-o", str(tmp_path / "r.png"), *CPU])


@pytest.mark.parametrize("argv", [
    ["view"],
    ["export", "-o", "x.glb"],
    ["render", "--scene", "scene.glb"],
    ["render", "--env-importance"],
    ["render", "--blue-noise"],
    ["render", "--shard-tiles", "2"],
], ids=["view", "export", "gltf", "env_importance", "blue_noise", "shard"])
def test_cli_unported_options_raise(argv, tmp_path, monkeypatch):
    """Every option that raised until it was ported now works: `view`
    serves a 16x16 session (its /state read back, the server stopped),
    `export` writes a GLB of the default scene, a glTF `--scene` renders,
    and the env-importance and blue-noise options render a 16x16 image;
    sharding (ported) outside torchrun raises, since it has no process
    group to join, and renders nothing."""
    small = ["--width", "16", "--height", "16", "--frames", "2", "--bounces", "2"]
    if argv[0] == "view":
        from tpu_pathtracer_torch import viewer

        real, states = viewer.serve, []

        def serve(host, port, session, block=True):
            srv = real(host=host, port=0, session=session, block=False)
            try:
                t0 = time.time()
                while session.version < 2 and time.time() - t0 < 60:
                    time.sleep(0.02)
                with urllib.request.urlopen(srv.url + "state", timeout=30) as r:
                    states.append(json.loads(r.read()))
            finally:
                srv.stop()
            return srv

        monkeypatch.setattr(viewer, "serve", serve)
        assert main(argv + small + ["--env", "black", *CPU]) == 0
        assert states[0]["frame"] >= 2 and states[0]["params"]["env"] == "black"
        assert states[0]["resolution"]["width"] == 16
        return
    if argv[0] == "export" or "--scene" in argv:
        glb = tmp_path / "x.glb"
        assert main(["export", "-o", str(glb), "--draco"]) == 0
        meshes = load_gltf(str(glb), normalize=False)
        assert sum(len(m.indices) for m in meshes) == 1998
        if argv[0] == "export":
            return
        png = tmp_path / "r.png"
        assert main(["render", "--scene", str(glb), *small, "-o", str(png), *CPU]) == 0
        assert read_png(str(png)).shape[:2] == (16, 16)
        return
    if argv[1:] in (["--env-importance"], ["--blue-noise"]):
        png = tmp_path / "r.png"
        assert main(argv + small + ["--env", "sky", "-o", str(png), *CPU]) == 0
        img = read_png(str(png))
        assert img.shape[:2] == (16, 16) and img.max() > 0
        return
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    png = tmp_path / "r.png"
    with pytest.raises(RuntimeError, match="torchrun"):
        main(argv + ["-o", str(png), *CPU])
    assert not png.exists()


def test_hdr_codec_is_byte_equal_to_jax(tmp_path):
    rng = np.random.default_rng(3)
    img = (rng.random((9, 13, 3)) ** 4 * 50.0).astype(np.float32)
    img[0, 0] = 0.0
    a, b = str(tmp_path / "a.hdr"), str(tmp_path / "b.hdr")
    hdr.write_hdr(a, img)
    jhdr.write_hdr(b, img)
    assert open(a, "rb").read() == open(b, "rb").read()
    got = hdr.read_hdr(a)
    np.testing.assert_array_equal(got, jhdr.read_hdr(a))
    # RGBE shares one exponent a pixel: 8 bits of mantissa below its largest channel
    assert (np.abs(got - img) <= img.max(axis=-1, keepdims=True) / 128).all()


@pytest.mark.parametrize("spec", ["sky", "sky:elevation=30", "sky:elevation=5,azimuth=200,"
                                                             "turbidity=8,intensity=2"])
def test_sun_sky_is_byte_equal_to_jax(spec):
    kw = sky.parse_sky_spec(spec)
    assert kw == jsky.parse_sky_spec(spec)
    got = sky.sun_sky(32, 64, **kw)
    want = jsky.sun_sky(32, 64, **kw)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()

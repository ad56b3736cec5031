"""What surrounds the Triton march on the CPU: frames through the Triton
factory vs the XLA factory (interpret mode), the sharded frame on the
8-device mesh, the CLI's kernel choice, the stdlib PNG writer, the compile
cache rule and the device-memory query."""

import functools
import os

import jax
import numpy as np
import pytest

from vxtpu.camera.camera import Camera
from vxtpu.engine.sharding import make_mesh, render_image_sharded
from vxtpu.render.kernel_triton import make_march_triton
from vxtpu.render.kernel_xla import make_march_xla
from vxtpu.render.pipeline import render_image
from vxtpu.render.settings import RenderSettings
from vxtpu.world import distfield, procgen
from vxtpu.world.lights import Lights

DIMS = (32, 32, 32)
TRITON = functools.partial(make_march_triton, interpret=True)
CAM = Camera.make(pos=(-20.0, 16.0, 36.0), fov_y_deg=55.0).look_at(
    (16.0, 16.0, 8.0))
LIGHTS = Lights.single((5.0, -10.0, 45.0), intensity=2.0)

_SETTINGS = {
    "flat": RenderSettings(shading="flat"),
    "lambert": RenderSettings(shading="lambert"),
    "full": RenderSettings(shading="full", shadows=True, fog=True),
}


@pytest.mark.parametrize("shading", ["flat", "lambert", "full"])
@pytest.mark.parametrize("rgb", [False, True])
def test_frame_matches_xla_factory(shading, rgb):
    """Same scene, same distance field: the Triton and XLA marches give the
    same frame (palette and per-voxel RGB albedo)."""
    g = procgen.terrain(DIMS, seed=5, with_rgb=rgb)
    accel = distfield.build(g.occupancy)
    s = _SETTINGS[shading]
    a = render_image(functools.partial(TRITON, image_shape=(16, 24)), g, CAM,
                     LIGHTS, s, 16, 24, accel)
    b = render_image(make_march_xla, g, CAM, LIGHTS, s, 16, 24, accel)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_frame_with_texture_atlas():
    from vxtpu.world.atlas import build_procedural_atlas

    g = procgen.terrain(DIMS, seed=5)
    accel = distfield.build(g.occupancy)
    atlas = build_procedural_atlas(tex_size=4)
    s = _SETTINGS["lambert"]
    a = render_image(TRITON, g, CAM, LIGHTS, s, 12, 12, accel, atlas=atlas)
    b = render_image(make_march_xla, g, CAM, LIGHTS, s, 12, 12, accel,
                     atlas=atlas)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("h,w", [(16, 16), (9, 13)])
def test_sharded_frame_equals_single_device(h, w):
    """Rays sharded over the 8-device mesh, the kernel inside shard_map;
    9x13 rays do not divide the mesh (padding path)."""
    g = procgen.terrain(DIMS, seed=7)
    accel = distfield.build(g.occupancy)
    s = _SETTINGS["full"]
    a = render_image(TRITON, g, CAM, LIGHTS, s, h, w, accel)
    b = render_image_sharded(TRITON, g, CAM, LIGHTS, s, h, w, make_mesh(),
                             accel)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("name,module", [
    ("triton", "vxtpu.render.kernel_triton"),
    ("xla", "vxtpu.render.kernel_xla"),
    ("wavefront", "vxtpu.render.kernel_wavefront"),
    ("ref", "vxtpu.render.kernel_ref"),
])
def test_cli_kernel_factory(name, module):
    from vxtpu.app.run import _kernel_factory

    f = _kernel_factory(name, image_shape=(4, 4))
    target = f.func if isinstance(f, functools.partial) else f
    assert target.__module__ == module
    if name == "triton":
        assert f.keywords["image_shape"] == (4, 4)


@pytest.mark.parametrize("kernel", ["pallas", "pallas2", "fused",
                                    "pallas-interpret"])
def test_cli_refuses_removed_kernels(kernel):
    from vxtpu.app.run import main

    with pytest.raises(SystemExit):
        main(["render", "--kernel", kernel])


@pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (64, 64), (17, 40)])
def test_png_writer_round_trip(tmp_path, h, w):
    from PIL import Image

    from vxtpu.utils import save_png

    img = np.random.default_rng(h * w).random((h, w, 3)).astype(np.float32)
    p = str(tmp_path / "sub" / "f.png")
    save_png(p, img)                  # creates the missing directory
    back = np.asarray(Image.open(p))
    assert back.shape == (h, w, 3)
    np.testing.assert_array_equal(
        back, (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8))


def test_png_writer_rejects_other_shapes():
    from vxtpu.utils import encode_png

    with pytest.raises(ValueError):
        encode_png(np.zeros((4, 4), np.uint8))


def test_png_writer_needs_no_pillow():
    import vxtpu.utils as utils

    assert "PIL" not in open(utils.__file__).read()


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    from vxtpu.engine import platform

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.compilation_cache_dir() is None


def test_compile_cache_defaults_to_the_repo(monkeypatch):
    from vxtpu.engine import platform

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert platform.compilation_cache_dir() == os.path.join(repo,
                                                            ".jax_cache")


def test_enable_compile_cache_sets_no_dir_when_env_set(monkeypatch, tmp_path):
    from vxtpu.engine import platform

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    platform.enable_compilation_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_device_memory_unknown_is_an_error():
    from vxtpu.engine.platform import device_memory_bytes

    class NoStats:
        device_kind, platform = "mystery", "cpu"

        def memory_stats(self):
            return None

    with pytest.raises(RuntimeError, match="no memory limit"):
        device_memory_bytes(NoStats())


def test_device_memory_from_bytes_limit():
    from vxtpu.engine.platform import device_memory_bytes

    class Card:
        device_kind, platform = "card", "gpu"

        def memory_stats(self):
            return {"bytes_limit": 123, "bytes_in_use": 7}

    assert device_memory_bytes(Card()) == 123


def test_validate_platform_checks_mesh_size():
    from vxtpu.engine.platform import validate_platform

    assert validate_platform(mesh_devices=8).num_devices == 8
    with pytest.raises(RuntimeError, match="requested mesh"):
        validate_platform(mesh_devices=64)

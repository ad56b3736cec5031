"""Golden-image regression tests — the formalized version of the reference
author's render-and-eyeball validation loop (SURVEY.md §5): checked-in PNGs
with tolerance catch silent shading/march regressions.

Goldens live in tests/golden/ at 64x64, rendered by the XLA fast path on CPU
(which is itself oracle-parity-locked); the Triton march must reproduce
them too. Regenerate deliberately with
``python tests/test_golden.py regen`` after an intentional visual change.
"""

import os

import numpy as np
import pytest

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
DIMS = (48, 48, 48)


def _scene():
    from vxtpu.camera.camera import Camera
    from vxtpu.world import procgen
    from vxtpu.world.lights import Lights

    g = procgen.terrain(DIMS, seed=11)
    s = procgen.shell_sphere(DIMS)
    cam = Camera.make(pos=(-30.0, 24.0, 52.0), fov_y_deg=55.0).look_at(
        (24.0, 24.0, 14.0)
    )
    lights = Lights.single((8.0, -15.0, 70.0), intensity=2.0)
    return g, s, cam, lights


def _render(name, kernel="xla"):
    """The golden frame ``name`` through the XLA march (pyramid or plain
    DDA, as the golden was made) or through the Triton march (interpret
    mode; it reads a distance field)."""
    import functools

    from vxtpu.render.kernel_triton import make_march_triton
    from vxtpu.render.kernel_xla import make_march_xla
    from vxtpu.render.pipeline import render_image
    from vxtpu.render.settings import RenderSettings
    from vxtpu.world import distfield
    from vxtpu.world.pyramid import build_pyramid

    g, s, cam, lights = _scene()
    grid = s if name == "sphere_lambert" else g
    settings = {
        "terrain_flat": RenderSettings(shading="flat"),
        "terrain_lambert": RenderSettings(shading="lambert"),
        "terrain_full": RenderSettings.full(pyramid_levels=2),
        "sphere_lambert": RenderSettings(shading="lambert"),
    }[name]
    if kernel == "triton":
        factory = functools.partial(make_march_triton, interpret=True,
                                    image_shape=(64, 64))
        accel = distfield.build(grid.occupancy)
    else:
        factory = make_march_xla
        accel = (build_pyramid(grid.occupancy, 2)
                 if name == "terrain_full" else None)
    return render_image(factory, grid, cam, lights, settings, 64, 64, accel)


GOLDENS = ["terrain_flat", "terrain_lambert", "terrain_full",
           "sphere_lambert"]


@pytest.mark.parametrize("kernel", ["xla", "triton"])
@pytest.mark.parametrize("name", GOLDENS)
def test_golden(name, kernel):
    from PIL import Image

    path = os.path.join(GOLDEN_DIR, f"{name}.png")
    want = np.asarray(Image.open(path)).astype(np.float32) / 255.0
    got = np.clip(np.asarray(_render(name, kernel)), 0.0, 1.0)
    # quantization allows 1/255 everywhere; permit a few boundary pixels to
    # move (fp-grazing rays), but no broad drift
    diff = np.abs(got - want).max(axis=-1)
    assert (diff <= 2.5 / 255.0).mean() > 0.998, f"{name}: drifted"
    assert diff.mean() < 1.0 / 255.0, f"{name}: mean drift {diff.mean()}"


if __name__ == "__main__":
    import sys

    from PIL import Image

    if len(sys.argv) > 1 and sys.argv[1] == "regen":
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        for n in GOLDENS:
            arr = (np.clip(np.asarray(_render(n)), 0, 1) * 255).astype(np.uint8)
            Image.fromarray(arr).save(os.path.join(GOLDEN_DIR, f"{n}.png"))
            print("wrote", n)

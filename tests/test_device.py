"""Tests that need the card: the Triton march compiled for the GPU, the
frame through it, and the train step's gradients. They skip elsewhere; run
them on a GPU machine with

    VXTPU_TEST_PLATFORM=cuda python -m pytest -m gpu tests/test_device.py

Interpret-mode parity on the CPU (tests/test_triton.py) cannot show what the
GPU compiler does: whether the kernel compiles, and whether contracted
multiply-adds move a grazing ray to the other side of a voxel edge.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu

DIMS = (64, 64, 64)


@pytest.fixture(scope="module")
def scene():
    from vxtpu.camera.camera import Camera
    from vxtpu.camera.rays import generate_rays
    from vxtpu.world import procgen

    grid = procgen.terrain(DIMS, seed=11, with_rgb=True)
    cam = Camera.make(pos=(-40.0, 32.0, 80.0)).look_at((32.0, 32.0, 20.0))
    o, d = generate_rays(cam, 64, 64)
    return grid, cam, o, d


def test_triton_march_matches_oracle_on_device(gpu, scene):
    import jax

    from vxtpu.render.kernel_ref import make_march_ref
    from vxtpu.render.kernel_triton import make_march_triton
    from vxtpu.render.settings import RenderSettings

    grid, _, o, d = scene
    occ = grid.occupancy.reshape(-1)
    s = RenderSettings()
    r = jax.jit(make_march_ref(occ, DIMS, s))(o, d)
    f = jax.jit(make_march_triton(occ, DIMS, s, image_shape=(64, 64)))(o, d)
    hit_r, hit_f = np.asarray(r.hit), np.asarray(f.hit)
    assert (hit_r == hit_f).mean() >= 0.998
    both = hit_r & hit_f
    np.testing.assert_allclose(np.asarray(f.t)[both], np.asarray(r.t)[both],
                               rtol=1e-4, atol=1e-3)


def test_triton_frame_matches_xla_frame_on_device(gpu, scene):
    import functools

    from vxtpu.render.kernel_triton import make_march_triton
    from vxtpu.render.kernel_xla import make_march_xla
    from vxtpu.render.pipeline import render_image
    from vxtpu.render.settings import RenderSettings
    from vxtpu.world import distfield
    from vxtpu.world.lights import Lights

    grid, cam, _, _ = scene
    accel = distfield.build(grid.occupancy)
    lights = Lights.single((10.0, -20.0, 90.0), intensity=2.0)
    s = RenderSettings(shading="full", shadows=True, fog=True)
    tri = functools.partial(make_march_triton, image_shape=(96, 128))
    a = np.asarray(render_image(tri, grid, cam, lights, s, 96, 128, accel))
    b = np.asarray(render_image(make_march_xla, grid, cam, lights, s, 96,
                                128, accel))
    assert (np.abs(a - b).max(-1) > 2 / 255).mean() <= 0.002


def test_custom_vjp_grads_on_device(gpu, scene):
    """Custom-VJP backward matches autodiff in full float32."""
    import jax
    import jax.numpy as jnp

    from vxtpu.render.settings import RenderSettings
    from vxtpu.render.soft import SoftGrid, render_soft_rays
    from vxtpu.render.vjp import render_soft_rays_fast

    grid, _, o, d = scene
    settings = RenderSettings()
    soft = SoftGrid.from_hard(grid, sigma_solid=10.0)

    def loss_ref(s):
        pred, _ = render_soft_rays(s, o, d, settings, 24)
        return jnp.mean(pred ** 2)

    def loss_fast(s):
        return jnp.mean(render_soft_rays_fast(s, o, d, settings, 24) ** 2)

    with jax.default_matmul_precision("highest"):
        g_ref = jax.jit(jax.grad(loss_ref))(soft)
        g_fast = jax.jit(jax.grad(loss_fast))(soft)
    for a, b in zip(jax.tree_util.tree_leaves(g_ref),
                    jax.tree_util.tree_leaves(g_fast)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(a)


def test_train_steps_descend_on_device(gpu, scene):
    from vxtpu.render.settings import RenderSettings
    from vxtpu.render.soft import SoftGrid, render_soft_image
    from vxtpu.train.loop import TrainConfig, fit_soft

    grid, cam, _, _ = scene
    st = RenderSettings()
    target = render_soft_image(SoftGrid.from_hard(grid), cam, st, 32, 32, 64)
    cfg = TrainConfig(steps=8, num_samples=64, use_custom_vjp=True)
    _, _, losses, _ = fit_soft(SoftGrid.zeros(DIMS), cam, target, st, cfg)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]

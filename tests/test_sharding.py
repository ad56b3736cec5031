"""Distribution tests on an 8-virtual-device CPU mesh (SURVEY.md §5
"Distributed without a cluster"): sharded render == single-device render;
sharded training step reduces loss with psum'd grads."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vxtpu.camera.camera import Camera
from vxtpu.engine.sharding import (
    camera_frame_rays, make_mesh, make_sharded_train_step, render_image_sharded,
)
from vxtpu.render.kernel_xla import make_march_xla
from vxtpu.render.pipeline import render_image
from vxtpu.render.settings import RenderSettings
from vxtpu.render.soft import SoftGrid, render_soft_image
from vxtpu.world import procgen
from vxtpu.world.lights import Lights
from vxtpu.world.pyramid import build_pyramid

DIMS = (32, 32, 32)


def test_mesh_has_8_devices():
    mesh = make_mesh()
    assert mesh.devices.size == 8


def test_sharded_render_parity():
    g = procgen.terrain(DIMS, seed=7)
    cam = Camera.make(pos=(-20.0, 16.0, 40.0)).look_at((16.0, 16.0, 10.0))
    L = Lights.single((0.0, 16.0, 60.0), intensity=2.0)
    s = RenderSettings(pyramid_levels=2)
    pyr = build_pyramid(g.occupancy, 2)
    a = np.array(render_image(make_march_xla, g, cam, L, s, 24, 24, pyr))
    b = np.array(
        render_image_sharded(make_march_xla, g, cam, L, s, 24, 24, make_mesh(), pyr)
    )
    assert np.allclose(a, b, atol=1e-6)


def test_sharded_render_nondivisible_rays():
    """Ray count not divisible by 8 exercises the padding path."""
    g = procgen.solid_box(DIMS, (8, 8, 8), (24, 24, 20))
    cam = Camera.make(pos=(-20.0, 16.0, 30.0)).look_at((16.0, 16.0, 14.0))
    s = RenderSettings(shading="flat")
    a = np.array(render_image(make_march_xla, g, cam, Lights.none(), s, 9, 13))
    b = np.array(
        render_image_sharded(make_march_xla, g, cam, Lights.none(), s, 9, 13, make_mesh())
    )
    assert np.allclose(a, b, atol=1e-6)


def test_sharded_train_step_descends():
    mesh = make_mesh()
    grid = procgen.shell_sphere(DIMS)
    truth = SoftGrid.from_hard(grid, sigma_solid=20.0)
    cam = Camera.make(pos=(-20.0, 16.0, 16.0)).look_at((16.0, 16.0, 16.0))
    H = W = 16
    s = RenderSettings()
    target = render_soft_image(truth, cam, s, H, W, num_samples=32).reshape(-1, 3)
    o_c, d_c = camera_frame_rays(cam, H, W)

    soft = SoftGrid.zeros(DIMS)
    init_fn, step_fn = make_sharded_train_step(s, 32, mesh, lr=5e-2,
                                               optimize_camera=True)
    opt_state = init_fn(soft, cam)
    losses = []
    for i in range(12):
        soft, cam, opt_state, loss = step_fn(soft, cam, opt_state, o_c, d_c, target)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7, losses
    assert np.isfinite(losses).all()


def test_sharded_vs_single_device_grads_match():
    """psum'd sharded gradient == single-device full-batch gradient."""
    from vxtpu.render.soft import render_soft_rays
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    import functools

    mesh = make_mesh()
    grid = procgen.solid_box(DIMS, (10, 10, 10), (20, 20, 20))
    soft = SoftGrid.from_hard(grid, sigma_solid=10.0)
    cam = Camera.make(pos=(-15.0, 16.0, 16.0)).look_at((16.0, 16.0, 16.0))
    s = RenderSettings()
    from vxtpu.camera.rays import generate_rays

    o, d = generate_rays(cam, 8, 16)
    tgt = jnp.zeros((128, 3))

    def full_loss(soft):
        pred, _ = render_soft_rays(soft, o, d, s, 16)
        return jnp.mean((pred - tgt) ** 2)

    g_single = jax.grad(full_loss)(soft)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P("rays"), P("rays"), P("rays")),
        out_specs=P(), check_vma=False,
    )
    def sharded_grad(soft, o_s, d_s, t_s):
        def lf(sf):
            pred, _ = render_soft_rays(sf, o_s, d_s, s, 16)
            return jnp.sum((pred - t_s) ** 2) / (128 * 3)
        return jax.lax.psum(jax.grad(lf)(soft), "rays")

    g_shard = sharded_grad(soft, o, d, tgt)
    for a, b in zip(jax.tree_util.tree_leaves(g_single), jax.tree_util.tree_leaves(g_shard)):
        np.testing.assert_allclose(np.array(a), np.array(b), rtol=1e-4, atol=1e-6)


def test_bucketed_psum_matches_monolithic():
    """grad_buckets>1 pipelines per-bucket psums with the backward
    (BASELINE north star "psum overlapped with backward traversal");
    the bucketed gradient must equal the monolithic-psum gradient.
    SGD(1.0) makes param deltas == gradients (adam would amplify fp
    reassociation noise at near-zero gradients into percent-level param
    diffs, which is optimizer conditioning, not a psum defect)."""
    import optax

    mesh = make_mesh()
    grid = procgen.shell_sphere(DIMS)
    truth = SoftGrid.from_hard(grid, sigma_solid=20.0)
    cam = Camera.make(pos=(-20.0, 16.0, 16.0)).look_at((16.0, 16.0, 16.0))
    H = W = 16
    s = RenderSettings()
    target = render_soft_image(truth, cam, s, H, W, num_samples=32).reshape(-1, 3)
    o_c, d_c = camera_frame_rays(cam, H, W)

    outs = {}
    for buckets in (1, 4):
        soft = SoftGrid.zeros(DIMS)
        init_fn, step_fn = make_sharded_train_step(
            s, 32, mesh, optimize_camera=True, grad_buckets=buckets,
            optimizer=optax.sgd(1.0), cam_optimizer=optax.sgd(1.0))
        opt_state = init_fn(soft, cam)
        soft1, cam1, _, loss = step_fn(soft, cam, opt_state, o_c, d_c, target)
        outs[buckets] = (soft1, cam1, float(loss))

    s1, c1, l1 = outs[1]
    s4, c4, l4 = outs[4]
    np.testing.assert_allclose(l1, l4, rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves((s1, c1)),
                    jax.tree_util.tree_leaves((s4, c4))):
        np.testing.assert_allclose(np.array(a), np.array(b),
                                   rtol=1e-4, atol=1e-6)


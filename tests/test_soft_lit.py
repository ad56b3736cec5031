"""Lit soft mode: density-gradient-normal lambert /
Blinn-Phong shading of the volumetric renderer, so config 4/5 optimization
targets resemble the hard render ladder (configs 2-3) — plus its custom-VJP
parity and the loud scope-cut warnings."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vxtpu.camera.camera import Camera
from vxtpu.render.settings import RenderSettings
from vxtpu.render.soft import (SoftGrid, render_soft_rays, trilinear,
                               trilinear_grad)
from vxtpu.render.vjp import render_soft_rays_fast
from vxtpu.world import procgen
from vxtpu.world.lights import Lights

DIMS = (16, 16, 16)
S = 32


def _scene():
    soft = SoftGrid.from_hard(procgen.shell_sphere(DIMS), sigma_solid=15.0)
    cam = Camera.make(pos=(-12.0, 8.0, 10.0), fov_y_deg=55.0).look_at(
        (8.0, 8.0, 8.0))
    from vxtpu.camera.rays import generate_rays

    o, d = generate_rays(cam, 12, 12)
    lights = Lights.single((-4.0, -6.0, 30.0), intensity=2.0)
    return soft, o, d, lights


def test_trilinear_grad_matches_autodiff():
    """The analytic interpolation gradient == jax.grad of trilinear()."""
    key = jax.random.PRNGKey(0)
    vals = jax.random.normal(key, DIMS)
    # stay inside cells (away from the floor() discontinuities)
    p = jnp.asarray([[3.3, 4.7, 5.2], [8.1, 2.9, 10.6], [1.2, 1.8, 2.4]])
    g_analytic = trilinear_grad(vals, p, DIMS)
    g_auto = jax.vmap(jax.grad(lambda q: trilinear(vals, q, DIMS)))(p)
    np.testing.assert_allclose(np.asarray(g_analytic), np.asarray(g_auto),
                               rtol=1e-5, atol=1e-6)


def test_lit_mode_changes_the_image_and_honors_shading():
    soft, o, d, lights = _scene()
    st_flat = RenderSettings(shading="flat")
    st_lam = RenderSettings(shading="lambert")
    st_full = RenderSettings(shading="full")
    em, _ = render_soft_rays(soft, o, d, st_flat, S, lights)
    lam, _ = render_soft_rays(soft, o, d, st_lam, S, lights)
    full, _ = render_soft_rays(soft, o, d, st_full, S, lights)
    # flat ignores lights entirely == no-lights render
    em2, _ = render_soft_rays(soft, o, d, st_flat, S, None)
    np.testing.assert_allclose(np.asarray(em), np.asarray(em2))
    assert not np.allclose(np.asarray(em), np.asarray(lam), atol=1e-3)
    assert not np.allclose(np.asarray(lam), np.asarray(full), atol=1e-4)


@pytest.mark.parametrize("shading", ["lambert", "full"])
def test_lit_custom_vjp_forward_parity(shading):
    soft, o, d, lights = _scene()
    st = RenderSettings(shading=shading)
    ref, _ = render_soft_rays(soft, o, d, st, S, lights)
    fast = render_soft_rays_fast(soft, o, d, st, S, lights)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                               rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("shading", ["lambert", "full"])
def test_lit_custom_vjp_grads_match_autodiff(shading):
    """Custom-VJP gradients == autodiff through the reference lit renderer,
    for the soft grid, rays AND light parameters."""
    soft, o, d, lights = _scene()
    st = RenderSettings(shading=shading)

    def loss_ref(soft, o, d, lights):
        rgb, _ = render_soft_rays(soft, o, d, st, S, lights)
        return jnp.sum(rgb * jnp.cos(jnp.arange(rgb.size).reshape(rgb.shape)))

    def loss_fast(soft, o, d, lights):
        rgb = render_soft_rays_fast(soft, o, d, st, S, lights)
        return jnp.sum(rgb * jnp.cos(jnp.arange(rgb.size).reshape(rgb.shape)))

    g_ref = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(soft, o, d, lights)
    g_fast = jax.grad(loss_fast, argnums=(0, 1, 2, 3))(soft, o, d, lights)
    for a, b in zip(jax.tree_util.tree_leaves(g_ref),
                    jax.tree_util.tree_leaves(g_fast)):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   rtol=5e-4, atol=5e-5)


def test_density_gradient_normals_point_outward():
    """On a solid sphere, -grad(sigma_raw) at points just outside the
    surface points away from the center."""
    soft = SoftGrid.from_hard(procgen.shell_sphere(DIMS), sigma_solid=15.0)
    center = jnp.asarray([8.0, 8.0, 8.0])
    dirs = jnp.asarray([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0],
                        [-1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])
    # shell_sphere radius = 0.35*16 = 5.6; probe just outside the shell
    p = center + 5.8 * dirs
    g = trilinear_grad(soft.sigma_raw, p, DIMS)
    outward = jnp.sum(-g * dirs, axis=-1)
    assert bool(jnp.all(outward > 0)), np.asarray(outward)


def test_scope_cut_warnings():
    soft, o, d, lights = _scene()
    import vxtpu.render.soft as soft_mod

    soft_mod._warned_scope.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        render_soft_rays(soft, o, d,
                         RenderSettings(shading="full", shadows=True,
                                        fog=True), S, lights)
    assert any("shadow" in str(w.message) for w in rec)

    soft_mod._warned_scope.clear()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        render_soft_rays(soft, o, d, RenderSettings(shading="lambert"), S,
                         None)
    assert any("no lights" in str(w.message) for w in rec)

"""The §5 gradient tier: custom-VJP vs autodiff-through-the-reference-soft-
renderer allclose, plus the SURVEY §6 determinism guarantee (same seed ->
bitwise-same grads; on the CPU — on the GPU the scatter-add runs on atomics,
see README "Determinism")."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vxtpu.camera.camera import Camera
from vxtpu.render.settings import RenderSettings
from vxtpu.render.soft import SoftGrid, render_soft_rays, render_soft_image
from vxtpu.render.vjp import render_soft_rays_fast, render_soft_image_fast
from vxtpu.world import procgen

DIMS = (12, 12, 12)
S = 24


def _scene():
    soft = SoftGrid.from_hard(procgen.shell_sphere(DIMS), sigma_solid=12.0)
    # non-trivial densities everywhere so gradients are dense
    key = jax.random.PRNGKey(3)
    soft = SoftGrid(
        sigma_raw=soft.sigma_raw + 0.3 * jax.random.normal(key, DIMS),
        rgb_raw=soft.rgb_raw,
    )
    cam = Camera.make(pos=(-9.0, 6.0, 7.0)).look_at((6.0, 6.0, 6.0))
    from vxtpu.camera.rays import generate_rays

    o, d = generate_rays(cam, 9, 7)
    return soft, cam, o, d


def test_forward_parity():
    soft, _, o, d = _scene()
    st = RenderSettings()
    ref, _ = render_soft_rays(soft, o, d, st, S)
    fast = render_soft_rays_fast(soft, o, d, st, S)
    np.testing.assert_allclose(np.asarray(fast), np.asarray(ref),
                               rtol=1e-5, atol=1e-6)


def test_grad_parity_vs_autodiff():
    soft, _, o, d = _scene()
    st = RenderSettings()
    tgt = jnp.linspace(0, 1, o.shape[0] * 3).reshape(-1, 3)

    def loss_ref(soft, o, d):
        pred, _ = render_soft_rays(soft, o, d, st, S)
        return jnp.mean((pred - tgt) ** 2)

    def loss_fast(soft, o, d):
        pred = render_soft_rays_fast(soft, o, d, st, S)
        return jnp.mean((pred - tgt) ** 2)

    lr, gr = jax.value_and_grad(loss_ref, argnums=(0, 1, 2))(soft, o, d)
    lf, gf = jax.value_and_grad(loss_fast, argnums=(0, 1, 2))(soft, o, d)
    np.testing.assert_allclose(float(lf), float(lr), rtol=1e-5)
    for a, b, name in [
        (gf[0].sigma_raw, gr[0].sigma_raw, "sigma"),
        (gf[0].rgb_raw, gr[0].rgb_raw, "rgb"),
        (gf[1], gr[1], "origins"),
        (gf[2], gr[2], "dirs"),
    ]:
        scale = max(float(jnp.max(jnp.abs(b))), 1e-8)
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-5 * scale,
            err_msg=f"grad mismatch: {name}",
        )


def test_camera_pose_grad_chain():
    """Pose grads through generate_rays: custom-VJP path == autodiff path."""
    soft, cam, _, _ = _scene()
    st = RenderSettings()
    target = render_soft_image(soft, cam, st, 8, 8, S)

    def loss_ref(c):
        img = render_soft_image(soft, c, st, 8, 8, S)
        return jnp.mean((img - target + 0.01) ** 2)

    def loss_fast(c):
        img = render_soft_image_fast(soft, c, st, 8, 8, S)
        return jnp.mean((img - target + 0.01) ** 2)

    gr = jax.grad(loss_ref)(cam)
    gf = jax.grad(loss_fast)(cam)
    for a, b, name in [(gf.pos, gr.pos, "pos"), (gf.yaw, gr.yaw, "yaw"),
                       (gf.pitch, gr.pitch, "pitch")]:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=3e-4, atol=1e-7,
                                   err_msg=f"cam grad mismatch: {name}")


def test_finite_difference_spot_check():
    """Direct numeric check of the custom backward, independent of autodiff."""
    soft, _, o, d = _scene()
    st = RenderSettings()
    o, d = o[:5], d[:5]

    def f(sr):
        pred = render_soft_rays_fast(
            SoftGrid(sigma_raw=sr, rgb_raw=soft.rgb_raw), o, d, st, S)
        return jnp.sum(pred)

    g = jax.grad(f)(soft.sigma_raw)
    idx = jnp.unravel_index(jnp.argmax(jnp.abs(g)), DIMS)
    eps = 1e-3
    up = soft.sigma_raw.at[idx].add(eps)
    dn = soft.sigma_raw.at[idx].add(-eps)
    fd = (f(up) - f(dn)) / (2 * eps)
    assert abs(float(fd) - float(g[idx])) <= 2e-3 * max(abs(float(fd)), 1.0)


def test_grad_determinism_bitwise():
    """SURVEY §6: same seed -> bitwise-same grads. The backward's voxel-grad
    accumulation is a deterministic XLA scatter-add; two identical runs must
    produce identical bits."""
    soft, _, o, d = _scene()
    st = RenderSettings()
    tgt = jnp.zeros((o.shape[0], 3))

    @jax.jit
    def grads(soft, o, d):
        def loss(s):
            pred = render_soft_rays_fast(s, o, d, st, S)
            return jnp.mean((pred - tgt) ** 2)
        return jax.grad(loss)(soft)

    g1 = grads(soft, o, d)
    g2 = grads(soft, o, d)
    assert np.array_equal(np.asarray(g1.sigma_raw), np.asarray(g2.sigma_raw))
    assert np.array_equal(np.asarray(g1.rgb_raw), np.asarray(g2.rgb_raw))


def test_fit_soft_uses_custom_vjp():
    """Training-loop smoke test on the fast path + NaN guard wiring."""
    from vxtpu.train.loop import TrainConfig, fit_soft

    dims = (10, 10, 10)
    truth = SoftGrid.from_hard(procgen.shell_sphere(dims), sigma_solid=12.0)
    cam = Camera.make(pos=(-8.0, 5.0, 6.0)).look_at((5.0, 5.0, 5.0))
    st = RenderSettings()
    target = render_soft_image(truth, cam, st, 12, 12, 32)
    soft0 = SoftGrid.zeros(dims)
    cfg = TrainConfig(steps=12, num_samples=32, use_custom_vjp=True)
    soft, _, losses, _ = fit_soft(soft0, cam, target, st, cfg)
    assert losses[-1] < losses[0]
    assert all(np.isfinite(losses))

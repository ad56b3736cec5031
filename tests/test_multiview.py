"""Multi-view inverse rendering (BASELINE config 4: "optimize voxel
colors/densities from target imageS"): recover a known scene from 8 orbit
views to a PSNR threshold (single-view fitting is ill-posed)."""

import jax.numpy as jnp
import numpy as np

from vxtpu.camera import paths
from vxtpu.render.settings import RenderSettings
from vxtpu.render.soft import SoftGrid, render_soft_image
from vxtpu.train.loop import TrainConfig, fit_soft_views
from vxtpu.train.loss import psnr
from vxtpu.world import procgen

DIMS = (16, 16, 16)
S = 48
HW = 24


def test_recover_shell_sphere_from_8_views():
    truth = SoftGrid.from_hard(procgen.shell_sphere(DIMS), sigma_solid=20.0)
    st = RenderSettings()
    cams = paths.orbit_views(center=(8.0, 8.0, 8.0), radius=14.0, height=12.0,
                             n=8, fov_y_deg=55.0)
    targets = jnp.stack(
        [render_soft_image(truth, c, st, HW, HW, S) for c in cams])

    soft0 = SoftGrid.zeros(DIMS)
    cfg = TrainConfig(steps=120, num_samples=S, lr=2e-1, ray_batch=2048,
                      tv_sigma=1e-5, tv_rgb=1e-6, seed=0)
    soft, losses, _ = fit_soft_views(soft0, cams, targets, st, cfg)
    assert losses[-1] < losses[0] / 5

    # held-out view: the recovered grid must render a novel pose well
    held = paths.orbit_views(center=(8.0, 8.0, 8.0), radius=14.0,
                             height=12.0, n=16, fov_y_deg=55.0)[1]
    img = render_soft_image(soft, held, st, HW, HW, S)
    ref = render_soft_image(truth, held, st, HW, HW, S)
    p = float(psnr(img, ref))
    assert p > 20.0, f"held-out PSNR too low: {p:.2f} dB"


def test_multiview_beats_single_view():
    """The reason fit_soft_views exists: same budget, one view vs eight —
    multi-view generalizes to a held-out pose, single-view does not."""
    truth = SoftGrid.from_hard(procgen.shell_sphere(DIMS), sigma_solid=20.0)
    st = RenderSettings()
    cams = paths.orbit_views(center=(8.0, 8.0, 8.0), radius=14.0, height=12.0,
                             n=8, fov_y_deg=55.0)
    targets = jnp.stack(
        [render_soft_image(truth, c, st, HW, HW, S) for c in cams])
    held = paths.orbit_views(center=(8.0, 8.0, 8.0), radius=14.0,
                             height=12.0, n=16, fov_y_deg=55.0)[3]
    ref = render_soft_image(truth, held, st, HW, HW, S)

    cfg = TrainConfig(steps=60, num_samples=S, lr=2e-1, ray_batch=2048,
                      tv_sigma=1e-5, tv_rgb=1e-6, seed=0)
    multi, _, _ = fit_soft_views(SoftGrid.zeros(DIMS), cams, targets, st, cfg)
    single, _, _ = fit_soft_views(SoftGrid.zeros(DIMS), cams[:1], targets[:1],
                               st, cfg)
    p_multi = float(psnr(render_soft_image(multi, held, st, HW, HW, S), ref))
    p_single = float(psnr(render_soft_image(single, held, st, HW, HW, S), ref))
    assert p_multi > p_single + 1.0, (p_multi, p_single)

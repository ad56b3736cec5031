"""Resume fidelity (SURVEY.md §6 checkpoint/resume): resuming from a
checkpoint must continue the EXACT optimizer trajectory — adam moments
included — so an interrupted run converges identically to an uninterrupted
one. This is the test that makes "--resume" a capability rather than a
flag."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from vxtpu.camera.camera import Camera
from vxtpu.render.settings import RenderSettings
from vxtpu.render.soft import SoftGrid, render_soft_image
from vxtpu.train.checkpoint import (load_checkpoint, load_opt_state,
                                    save_checkpoint)
from vxtpu.train.loop import TrainConfig, fit_soft, make_optimizer
from vxtpu.world import procgen

DIMS = (12, 12, 12)
HW = 16
S = 24


def _setup():
    truth = SoftGrid.from_hard(procgen.shell_sphere(DIMS), sigma_solid=20.0)
    st = RenderSettings()
    cam = Camera.make(pos=(-10.0, 6.0, 14.0), fov_y_deg=55.0).look_at(
        (6.0, 6.0, 6.0))
    target = render_soft_image(truth, cam, st, HW, HW, S)
    return st, cam, target


def test_resume_equals_uninterrupted(tmp_path):
    st, cam, target = _setup()
    base = TrainConfig(steps=10, num_samples=S, lr=1e-1, ray_batch=0,
                       tv_sigma=0.0, tv_rgb=0.0, nan_check_every=0)

    # uninterrupted: 10 steps
    soft_cont, _, _, _ = fit_soft(SoftGrid.zeros(DIMS), cam, target, st, base)

    # interrupted: 5 steps -> checkpoint (with opt state) -> restore -> 5 more
    half = dataclasses.replace(base, steps=5)
    soft_a, cam_a, _, opt_a = fit_soft(SoftGrid.zeros(DIMS), cam, target, st,
                                       half)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, soft_a, cam_a, step=5, opt_state=opt_a)

    soft_b, cam_b, _, extra = load_checkpoint(path)
    template = make_optimizer(half).init(soft_b)
    opt_b = load_opt_state(path, template)
    assert opt_b is not None, "opt state missing from checkpoint"
    soft_res, _, _, _ = fit_soft(soft_b, cam_b, target, st, half,
                                 opt_state=opt_b)

    np.testing.assert_allclose(np.asarray(soft_res.sigma_raw),
                               np.asarray(soft_cont.sigma_raw),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(soft_res.rgb_raw),
                               np.asarray(soft_cont.rgb_raw),
                               rtol=1e-5, atol=1e-6)


def test_resume_without_opt_state_diverges(tmp_path):
    """Control: a fresh-optimizer resume is NOT the continuous trajectory —
    this is exactly the gap opt-state checkpointing closes."""
    st, cam, target = _setup()
    base = TrainConfig(steps=10, num_samples=S, lr=1e-1, ray_batch=0,
                       tv_sigma=0.0, tv_rgb=0.0, nan_check_every=0)
    soft_cont, _, _, _ = fit_soft(SoftGrid.zeros(DIMS), cam, target, st, base)

    half = dataclasses.replace(base, steps=5)
    soft_a, _, _, _ = fit_soft(SoftGrid.zeros(DIMS), cam, target, st, half)
    soft_fresh, _, _, _ = fit_soft(soft_a, cam, target, st, half,
                                   opt_state=None)  # re-warmed moments
    assert not np.allclose(np.asarray(soft_fresh.sigma_raw),
                           np.asarray(soft_cont.sigma_raw),
                           rtol=1e-5, atol=1e-6)


def test_load_opt_state_shape_mismatch_raises(tmp_path):
    st, cam, target = _setup()
    cfg = TrainConfig(steps=2, num_samples=S, ray_batch=0, nan_check_every=0)
    soft, cam_o, _, opt = fit_soft(SoftGrid.zeros(DIMS), cam, target, st, cfg)
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, soft, cam_o, step=2, opt_state=opt)

    other = SoftGrid.zeros((8, 8, 8))
    template = make_optimizer(cfg).init(other)
    with pytest.raises(ValueError):
        load_opt_state(path, template)

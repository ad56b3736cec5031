"""Inverse-rendering optimization loop: fit a SoftGrid (voxel densities +
colors) and optionally the camera pose to target images.

This is new capability relative to the reference (which has no training,
SURVEY.md §1) but normative for the rebuild (BASELINE.json configs 4-5).
One jitted ``step`` closed over static config, driven from Python; the
carry is donated so grid + optimizer state stay resident in device memory.

Two entry points:
  fit_soft        — single target view (+ optional camera-pose refinement).
  fit_soft_views  — N views: BASELINE.json config 4's "optimize voxel
                    colors/densities from target imageS" — single-view
                    inverse rendering is ill-posed; N views make the
                    recovery real (tests/test_multiview.py demonstrates
                    PSNR recovery of a known scene from 8 orbit views).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import jax
import jax.numpy as jnp
import optax

from vxtpu.camera.camera import Camera
from vxtpu.camera.rays import generate_rays
from vxtpu.render.settings import RenderSettings
from vxtpu.render.soft import SoftGrid, render_soft_rays
from vxtpu.train.loss import mse, tv_loss


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 5e-2
    steps: int = 200
    num_samples: int = 128          # ray samples for the soft renderer
    tv_sigma: float = 1e-4          # TV regularizer weight on densities
    tv_rgb: float = 1e-5
    ray_batch: int = 0              # 0 = all rays every step; else minibatch
    optimize_camera: bool = False
    cam_lr: float = 1e-3
    seed: int = 0
    nan_check_every: int = 25       # pull loss to host every k steps; 0 = off
    use_custom_vjp: bool = False    # render via the custom-VJP fast path
    # occupancy-mask sample skipping (render/occmask.py): train the MASKED
    # soft model — density zero outside occupied coarse cells, samples
    # concentrated in each ray's occupied band, so num_samples can be cut
    # ~4x at the same in-band spacing. The mask starts all-ones (= the
    # plain model) and is refreshed from the current densities every
    # mask_refresh steps (instant-ngp/Plenoxels-style occupancy updates).
    occ_mask: bool = False
    mask_scale: int = 4
    mask_refresh: int = 50
    mask_tau: float = 0.01


def loss_fn(soft: SoftGrid, cam: Camera, o, d, target, hw,
             settings: RenderSettings, cfg: TrainConfig, mask=None,
             bounds=None):
    """target is always flat [N,3]. When optimizing the camera the rays are
    regenerated from the current pose (full image; hw = (H, W)) so pose
    gradients flow through ray generation. ``mask``: the occupancy-mask
    model's coarse mask (cfg.occ_mask)."""
    if cfg.optimize_camera:
        o, d = generate_rays(cam, *hw)

    if cfg.use_custom_vjp:
        from vxtpu.render.vjp import render_soft_rays_fast

        pred = render_soft_rays_fast(soft, o, d, settings, cfg.num_samples,
                                     None, mask, cfg.mask_scale, bounds)
    else:
        pred, _ = render_soft_rays(soft, o, d, settings, cfg.num_samples,
                                   mask=mask, mask_scale=cfg.mask_scale,
                                   seg_bounds=bounds)
    loss = mse(pred, target)
    if cfg.tv_sigma:
        loss = loss + cfg.tv_sigma * tv_loss(soft.sigma_raw)
    if cfg.tv_rgb:
        loss = loss + cfg.tv_rgb * tv_loss(soft.rgb_raw)
    return loss


def fit_soft_views(soft: SoftGrid, cams: list[Camera],
                   target_imgs: jax.Array, settings: RenderSettings,
                   cfg: TrainConfig,
                   log_fn: Callable[[int, float], None] | None = None,
                   opt_state=None):
    """Optimize a soft grid against N posed views (BASELINE config 4:
    "optimize voxel colors/densities from target images").

    cams: V cameras; target_imgs: [V,H,W,3]. Every step samples a ray
    minibatch uniformly over the union of all views' rays (cfg.ray_batch;
    0 = all rays of all views every step). Poses are fixed (known); use
    fit_soft(optimize_camera=True) for single-view pose refinement.
    ``opt_state`` resumes the optimizer (adam moments) from a checkpoint so
    a resumed run continues the uninterrupted trajectory.
    Returns (soft', losses [steps], opt_state').
    """
    assert target_imgs.ndim == 4 and target_imgs.shape[0] == len(cams)
    V, H, W = target_imgs.shape[:3]
    os_, ds_ = [], []
    for c in cams:
        o, d = generate_rays(c, H, W)
        os_.append(o)
        ds_.append(d)
    o = jnp.concatenate(os_, axis=0)
    d = jnp.concatenate(ds_, axis=0)
    target = target_imgs.reshape(-1, 3)
    cfg = dataclasses.replace(cfg, optimize_camera=False)
    soft, _, losses, opt_state = _fit_rays(soft, cams[0], o, d, target,
                                           (H, W), settings, cfg, log_fn,
                                           opt_state)
    return soft, losses, opt_state


def fit_soft(soft: SoftGrid, cam: Camera, target_img: jax.Array,
             settings: RenderSettings, cfg: TrainConfig,
             log_fn: Callable[[int, float], None] | None = None,
             opt_state=None):
    """Optimize soft-grid (and optionally camera pose) to match target_img
    [H,W,3] seen from cam. ``opt_state`` resumes the optimizer from a
    checkpoint. Returns (soft', cam', losses [steps], opt_state')."""
    H, W = target_img.shape[:2]
    o, d = generate_rays(cam, H, W)
    target = target_img.reshape(-1, 3)
    return _fit_rays(soft, cam, o, d, target, (H, W), settings, cfg, log_fn,
                     opt_state)


def make_optimizer(cfg: TrainConfig):
    """The optimizer fit_soft uses — exposed so resume paths can rebuild an
    opt_state template (train/checkpoint.py:load_opt_state)."""
    if cfg.optimize_camera:
        return optax.multi_transform(
            {"soft": optax.adam(cfg.lr), "cam": optax.adam(cfg.cam_lr)},
            ("soft", "cam"),
        )
    return optax.adam(cfg.lr)


def make_train_step(cam: Camera, hw, settings: RenderSettings,
                    cfg: TrainConfig):
    """The jitted optimizer step fit_soft runs:
    step(params, opt_state, o, d, target[, mask, t0, t1])
        -> (params, opt_state, loss)
    with params = soft, or (soft, cam) when cfg.optimize_camera. params and
    opt_state are donated."""
    opt = make_optimizer(cfg)

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, o_b, d_b, tgt_b, *mask_a):
        def lf(p):
            s, c = p if cfg.optimize_camera else (p, cam)
            return loss_fn(s, c, o_b, d_b, tgt_b, hw, settings, cfg,
                            mask_a[0] if mask_a else None,
                            (mask_a[1], mask_a[2]) if mask_a else None)
        loss, grads = jax.value_and_grad(lf)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def _fit_rays(soft: SoftGrid, cam: Camera, o, d, target, hw,
              settings: RenderSettings, cfg: TrainConfig,
              log_fn: Callable[[int, float], None] | None = None,
              opt_state=None):
    H, W = hw
    minibatched = bool(cfg.ray_batch) and cfg.ray_batch < o.shape[0]
    if cfg.optimize_camera and minibatched:
        raise ValueError("optimize_camera requires full-image steps (ray_batch=0)")

    params = (soft, cam) if cfg.optimize_camera else soft
    if opt_state is None:
        opt_state = make_optimizer(cfg).init(params)
    step = make_train_step(cam, hw, settings, cfg)

    mask = mask_df = None
    bounds_fn = None
    if cfg.occ_mask:
        from vxtpu.render.occmask import (mask_all_ones,
                                          mask_distance_field,
                                          mask_segment_bounds)

        mask = mask_all_ones(soft.dims, cfg.mask_scale)
        mask_df = mask_distance_field(mask)
        # bounds are a separate jitted program from the step, computed
        # per iteration from the current camera/rays, so the bounds march
        # is not repeated per gradient evaluation
        bounds_fn = jax.jit(functools.partial(mask_segment_bounds,
                                              scale=cfg.mask_scale))
    losses = []
    key = jax.random.PRNGKey(cfg.seed)
    n = o.shape[0]
    for i in range(cfg.steps):
        if (cfg.occ_mask and cfg.mask_refresh
                and i and i % cfg.mask_refresh == 0):
            from vxtpu.render.occmask import (mask_distance_field,
                                              occupancy_mask_from_soft)

            cur = params[0] if cfg.optimize_camera else params
            mask = occupancy_mask_from_soft(cur, cfg.mask_scale,
                                            tau=cfg.mask_tau, dilate=1)
            mask_df = mask_distance_field(mask)
        if minibatched:
            key, k = jax.random.split(key)
            idx = jax.random.randint(k, (cfg.ray_batch,), 0, n)
            o_b, d_b, t_b = o[idx], d[idx], target[idx]
        else:
            o_b, d_b, t_b = o, d, target
        mask_a = ()
        if cfg.occ_mask:
            if cfg.optimize_camera:
                cur_cam = params[1]
                o_r, d_r = generate_rays(cur_cam, H, W)
            else:
                o_r, d_r = o_b, d_b
            t0b, t1b = bounds_fn(mask, o=o_r, d=d_r, df_flat=mask_df)
            mask_a = (mask, t0b, t1b)
        params, opt_state, loss = step(params, opt_state, o_b, d_b, t_b,
                                       *mask_a)
        losses.append(loss)
        # NaN guard (SURVEY.md §6 "training-loop NaN guards"): periodic host
        # pull so a diverged run fails loudly instead of training on garbage.
        if cfg.nan_check_every and (i % cfg.nan_check_every == 0
                                    or i == cfg.steps - 1):
            lv = float(loss)
            if not (lv == lv and abs(lv) != float("inf")):
                raise FloatingPointError(
                    f"fit_soft: non-finite loss {lv} at step {i}"
                )
        if log_fn is not None and (i % 20 == 0 or i == cfg.steps - 1):
            log_fn(i, float(loss))
    losses = [float(l) for l in losses]
    if cfg.optimize_camera:
        soft_out, cam_out = params
    else:
        soft_out, cam_out = params, cam
    return soft_out, cam_out, losses, opt_state

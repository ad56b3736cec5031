"""Config 5 end-to-end driver (BASELINE.json configs[4]): an ANIMATED scene
whose frames are rendered with rays SHARDED over the device mesh while
camera-pose + voxel gradients descend PER FRAME.

Composition:
  app/schedule.py orbit path      -> the animated true camera
  engine/sharding.py              -> sharded target render + sharded
                                     train step (grads psum'd over the mesh)
  train/checkpoint.py             -> periodic save + --resume
  obs/metrics.py MetricsSink      -> per-frame loss/psnr/rays-per-sec

Scenario: a known "truth" grid is filmed by the animated camera; the
optimizer sees each target frame once and descends the replicated soft grid
AND its (deliberately mis-initialized) camera-pose estimate — the pose
error decays while the grid converges, demonstrating both gradient paths of
the north star on every frame. Multi-host: the same code runs SPMD after
jax.distributed.initialize() (engine/platform.py:init_multihost).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable

import jax
import jax.numpy as jnp

from vxtpu.camera import paths
from vxtpu.camera.camera import Camera
from vxtpu.engine.sharding import (
    camera_frame_rays,
    make_mesh,
    make_sharded_train_step,
    render_soft_image_sharded,
)
from vxtpu.obs.log import get_logger
from vxtpu.obs.metrics import MetricsSink
from vxtpu.render.settings import RenderSettings
from vxtpu.render.soft import SoftGrid
from vxtpu.train.checkpoint import (load_checkpoint, load_opt_state,
                                    save_checkpoint)
from vxtpu.train.loss import psnr
from vxtpu.world import procgen


@dataclasses.dataclass(frozen=True)
class Config5:
    dims: tuple[int, int, int] = (512, 512, 512)
    height: int = 1080
    width: int = 1920
    num_samples: int = 192
    frames: int = 24
    steps_per_frame: int = 2
    fps: float = 24.0
    lr: float = 5e-2
    cam_lr: float = 2e-3
    pose_error: float = 0.03        # initial yaw/pitch error (radians)
    seed: int = 7
    ckpt_every: int = 8             # frames between checkpoint saves
    sigma_solid: float = 25.0
    grad_buckets: int = 4           # per-bucket psum pipelined with backward
    lit: bool = True                # lit soft mode (density-gradient normals)
    use_custom_vjp: bool = True     # O(N+grid) backward (render/vjp.py)


def run_config5(cfg: Config5, settings: RenderSettings,
                mesh=None, out_dir: str | None = None,
                resume: str | None = None,
                sink: MetricsSink | None = None,
                save_frames: bool = False):
    """Run the animated sharded per-frame optimization.

    Returns dict with per-frame losses, psnrs, final pose errors, and the
    final (soft, cam) state. Pure-host loop around jitted SPMD steps; every
    device executes identical code (grid replicated, rays sharded).
    """
    log = get_logger(log_dir=out_dir)
    if mesh is None:
        mesh = make_mesh()
    if sink is None:
        sink = MetricsSink(echo=False)
    n_dev = mesh.devices.size
    log.info("config5: %d devices, dims=%s, %dx%d, %d samples, lit=%s, "
             "custom_vjp=%s, resume=%s", n_dev, cfg.dims, cfg.height,
             cfg.width, cfg.num_samples, cfg.lit, cfg.use_custom_vjp,
             resume or "no")
    assert (cfg.height * cfg.width) % n_dev == 0, (
        f"H*W={cfg.height * cfg.width} must divide evenly over {n_dev} "
        "devices (padding rays would perturb the mean loss)")

    X, Y, Z = cfg.dims
    truth_grid = procgen.terrain(cfg.dims, seed=cfg.seed, with_rgb=True)
    truth = SoftGrid.from_hard(truth_grid, sigma_solid=cfg.sigma_solid)
    # lit soft mode: targets AND optimization renders share the same light,
    # so config 5's scene resembles the hard ladder's look (configs 2-3)
    # instead of a flat-color proxy
    from vxtpu.world.lights import Lights

    lights = (Lights.single((0.2 * X, -0.3 * Y, 1.4 * Z), intensity=2.0)
              if cfg.lit and settings.shading != "flat" else None)
    cam_path = paths.orbit(
        center=(0.5 * X, 0.5 * Y, 0.3 * Z), radius=0.9 * X, height=1.1 * Z,
        period=cfg.frames / cfg.fps, fov_y_deg=55.0,
    )

    start_frame = 0
    soft = SoftGrid.zeros(cfg.dims)
    cam_off = jnp.asarray([cfg.pose_error, -cfg.pose_error], jnp.float32)
    if resume:
        soft, _, start_frame, extra = load_checkpoint(resume)
        if "cam_off" in extra:
            cam_off = extra["cam_off"]

    # bucketed psum only pays when there is a collective to overlap with
    # backward compute; on a single-device mesh the psum is degenerate and
    # bucketing is pure overhead — collapse to 1 bucket.
    buckets = cfg.grad_buckets if mesh.devices.size > 1 else 1
    init_fn, step_fn = make_sharded_train_step(
        settings, cfg.num_samples, mesh, lr=cfg.lr, cam_lr=cfg.cam_lr,
        optimize_camera=True, grad_buckets=buckets,
        lights=lights, use_custom_vjp=cfg.use_custom_vjp,
    )

    # one compiled program per frame render (soft grid and camera are
    # arguments, so every frame reuses it)
    render = jax.jit(lambda s, c: render_soft_image_sharded(
        s, c, settings, cfg.height, cfg.width, cfg.num_samples, mesh,
        lights=lights))

    losses, psnrs = [], []
    opt_state = None
    cam_est = None
    for f in range(start_frame, cfg.frames):
        t = jnp.float32(f / cfg.fps)
        cam_true = cam_path(t)
        target = render(truth, cam_true).reshape(-1, 3)

        # per-frame pose estimate: true pose + the current pose error
        # (carried across frames so the optimizer's corrections persist)
        cam_est = cam_true.replace(yaw=cam_true.yaw + cam_off[0],
                                   pitch=cam_true.pitch + cam_off[1])
        if opt_state is None:
            opt_state = init_fn(soft, cam_est)
            if resume:
                # restore adam moments so a resumed run continues the
                # uninterrupted trajectory (tests/test_resume.py)
                restored = load_opt_state(resume, opt_state)
                if restored is not None:
                    opt_state = restored

        loss = None
        for _ in range(cfg.steps_per_frame):
            o_c, d_c = camera_frame_rays(cam_est, cfg.height, cfg.width)
            soft, cam_est, opt_state, loss = step_fn(
                soft, cam_est, opt_state, o_c, d_c, target)
        # pose error after this frame's descent -> carried to next frame
        cam_off = jnp.stack([cam_est.yaw - cam_true.yaw,
                             cam_est.pitch - cam_true.pitch])

        lv = float(loss)
        if not (lv == lv and abs(lv) != float("inf")):
            raise FloatingPointError(f"config5: non-finite loss at frame {f}")
        losses.append(lv)

        pred = render(soft, cam_true)
        p = float(psnr(pred, target.reshape(cfg.height, cfg.width, 3)))
        psnrs.append(p)
        sink.emit(frame=f, loss=lv, psnr=p,
                  yaw_err=float(cam_off[0]), pitch_err=float(cam_off[1]))

        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            if save_frames:
                from vxtpu.utils import save_png

                save_png(os.path.join(out_dir, f"frame_{f:04d}.png"), pred)
            if cfg.ckpt_every and ((f + 1) % cfg.ckpt_every == 0
                                   or f == cfg.frames - 1):
                save_checkpoint(
                    os.path.join(out_dir, "ckpt.npz"), soft, cam_est,
                    step=f + 1, extra={"cam_off": cam_off},
                    opt_state=opt_state)

    return dict(losses=losses, psnrs=psnrs,
                yaw_err=float(cam_off[0]), pitch_err=float(cam_off[1]),
                soft=soft, cam=cam_est)

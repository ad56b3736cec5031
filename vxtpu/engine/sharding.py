"""Multi-chip / multi-host distribution: rays sharded over a device mesh.

The reference is single-device; its only parallelism is one OpenCL
work-item per pixel (SURVEY.md §3 "Parallelism table"). Here (normative per
BASELINE.json): tile rays, shard the tile axis across all devices with
``shard_map``, keep the voxel grid replicated (512³ attributes fit one
card's memory), and all-reduce voxel-attribute gradients with ``psum``
during training. Rendering needs NO
communication at all (rays are embarrassingly parallel); training needs
exactly one psum of grids+camera grads per step — the functional analog of
data-parallel gradient sync.

Multi-host: the same code runs SPMD on every host after
``jax.distributed.initialize()``; jax.make_mesh spans all processes'
devices automatically.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from vxtpu.camera.camera import Camera
from vxtpu.camera.rays import generate_rays
from vxtpu.render.settings import RenderSettings
from vxtpu.render.soft import SoftGrid, render_soft_rays
from vxtpu.train.loss import mse
from vxtpu.utils import round_up

RAY_AXIS = "rays"


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1D mesh over all (or first n) devices; axis name 'rays'.

    Uses the classic ``jax.sharding.Mesh`` (auto axis types): jax 0.9's
    ``jax.make_mesh`` defaults to explicit-sharding axes, which conflict
    with ``shard_map``-style manual collectives."""
    import numpy as np

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (RAY_AXIS,))


def _pad_rays(o, d, n_shards):
    """Pad ray count to a multiple of n_shards (padding rays point +z and
    are dropped after gather)."""
    n = o.shape[0]
    n_pad = round_up(n, n_shards) - n
    if n_pad:
        o = jnp.concatenate([o, jnp.zeros((n_pad, 3), o.dtype)], axis=0)
        d = jnp.concatenate(
            [d, jnp.tile(jnp.asarray([[0.0, 0.0, 1.0]], o.dtype), (n_pad, 1))], axis=0
        )
    return o, d, n


def render_image_sharded(march_factory, grid, cam: Camera, lights, settings,
                         height: int, width: int, mesh: Mesh, accel=None):
    """[H,W,3] frame with rays sharded over the mesh; grid replicated.

    accel: OccupancyPyramid / DistanceField / None — replicated like the grid.
    Bit-for-bit the same math as pipeline.render_image — sharding parity is
    tested on an 8-device CPU mesh (tests/test_sharding.py).
    """
    from vxtpu.render.pipeline import render_rays

    dims = grid.dims
    occ_flat = grid.occupancy.reshape(-1)
    albedo = grid.albedo()
    n_shards = mesh.devices.size
    o, d = generate_rays(cam, height, width)
    o, d, n_real = _pad_rays(o, d, n_shards)

    accel_leaves, accel_tree = jax.tree_util.tree_flatten(accel)

    @functools.partial(
        shard_map,
        mesh=mesh,
        # P() is a valid pytree-prefix spec: albedo (an Albedo pytree) and
        # every accel leaf are replicated; only the ray axis is sharded.
        in_specs=(P(RAY_AXIS), P(RAY_AXIS), P(), P(), *((P(),) * len(accel_leaves))),
        out_specs=P(RAY_AXIS),
        check_vma=False,  # jax 0.9 vma tracking rejects unvarying loop-carry init
    )
    def _render_shard(o_s, d_s, occ_s, albedo_s, *accel_s):
        acc = jax.tree_util.tree_unflatten(accel_tree, accel_s)
        march = march_factory(occ_s, dims, settings, acc)
        rgb, _ = render_rays(march, o_s, d_s, albedo_s, dims, lights, settings)
        return rgb

    rgb = _render_shard(o, d, occ_flat, albedo, *accel_leaves)
    return rgb[:n_real].reshape(height, width, 3)


def render_soft_image_sharded(soft: SoftGrid, cam: Camera,
                              settings: RenderSettings, height: int,
                              width: int, num_samples: int, mesh: Mesh,
                              lights=None):
    """[H,W,3] soft-volumetric frame with rays sharded over the mesh and the
    grid replicated — the forward-render half of config 5 (and the target
    generator for its per-frame optimization). ``lights`` (replicated)
    enables the lit soft mode."""
    n_shards = mesh.devices.size
    o, d = generate_rays(cam, height, width)
    o, d, n_real = _pad_rays(o, d, n_shards)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(RAY_AXIS), P(RAY_AXIS), P(), P()),
        out_specs=P(RAY_AXIS),
        check_vma=False,
    )
    def _render_shard(o_s, d_s, soft_s, lights_s):
        rgb, _ = render_soft_rays(soft_s, o_s, d_s, settings, num_samples,
                                  lights_s)
        return rgb

    rgb = _render_shard(o, d, soft, lights)
    return rgb[:n_real].reshape(height, width, 3)


def _world_rays(cam_p, o_s, d_s):
    """Camera-frame rays -> world rays (shared by the train step and the
    standalone bounds pass so both see IDENTICAL ray geometry)."""
    fwd, right, up = cam_p.basis()
    R = jnp.stack([fwd, right, up], axis=1)          # [3(world),3(cam)]
    return jnp.broadcast_to(cam_p.pos, o_s.shape) + o_s, d_s @ R.T


def compute_mask_bounds(mask, mask_df, cam, o_c, d_c, mask_scale: int = 4):
    """Standalone (jit-friendly) occupancy-band bounds for the masked
    train step: call once per step with the CURRENT camera and pass the
    result into step_fn. A separate program from the step, so the bounds
    march is not repeated per gradient bucket; jit it, since an eager call
    dispatches the whole mask march op by op."""
    from vxtpu.render.occmask import mask_segment_bounds

    o_w, d_w = _world_rays(cam, o_c, d_c)
    return mask_segment_bounds(mask, mask_scale, o_w, d_w,
                               df_flat=mask_df)


def make_sharded_train_step(settings: RenderSettings, num_samples: int,
                            mesh: Mesh, lr: float = 5e-2, cam_lr: float = 1e-3,
                            optimize_camera: bool = True,
                            grad_buckets: int = 1,
                            optimizer=None, cam_optimizer=None,
                            lights=None, use_custom_vjp: bool = False,
                            use_mask: bool = False, mask_scale: int = 4):
    """Jitted SPMD training step for config 5: rays sharded, grid replicated,
    grads psum'd over the mesh, identical adam update on every device.

    grad_buckets > 1 pipelines the gradient all-reduce with the backward
    pass (BASELINE north star: "psum overlapped with backward
    traversal"): the local ray shard is split into B microbatches and each
    microbatch's grads are psum'd THE MOMENT they are produced, so the
    collective for bucket i is in flight while bucket i+1's backward is still
    computing (XLA's latency-hiding scheduler overlaps them — the psum
    result is only needed at the final accumulate, never on the backward's
    critical path). Summing psums == psum'ing the sum up to fp
    reassociation; equality with the monolithic path is locked by
    tests/test_sharding.py::test_bucketed_psum_matches_monolithic.

    lights (replicated, not optimized) enables the lit soft mode;
    use_custom_vjp renders through the O(N_rays + grid) custom VJP
    (render/vjp.py) so backward residual memory stays flat at full-frame
    ray counts — the path config 5 runs at 1080p.

    use_mask=True switches to the MASKED soft model (render/occmask.py:
    density gated to zero outside occupied coarse mask cells) with
    empty-space-skipping sample bounds per microbatch — the occupancy-grid
    speedup (SURVEY §8 / PAPERS P:5,P:9): the same in-band sample spacing
    needs ~4-8x fewer samples. step_fn then takes trailing
    ``mask, t0, t1`` arguments: the uint8 [X/G,Y/G,Z/G] mask (replicated)
    plus per-ray segment bounds (sharded) from compute_mask_bounds — run
    THAT once per step with the current camera (and refresh mask +
    occmask.mask_distance_field periodically). The bounds pass is a
    separate program so it is not recomputed per grad bucket.

    Returns (init_fn, step_fn):
      init_fn(soft, cam) -> opt_state
      step_fn(soft, cam, opt_state, o, d, target[, mask, t0, t1])
          -> (soft, cam, opt_state, loss)
    with o/d/target sharded on axis 0 and soft/cam replicated.
    """
    import optax

    opt = optimizer if optimizer is not None else optax.adam(lr)
    cam_opt = cam_optimizer if cam_optimizer is not None else optax.adam(cam_lr)

    def init_fn(soft, cam: Camera):
        return (opt.init(soft), cam_opt.init(cam) if optimize_camera else None)

    def _local_loss(soft, cam_p, o_s, d_s, tgt_s, n_total, mask=None,
                    bounds=None):
        # rays are regenerated? No: o/d precomputed & sharded; camera grads
        # flow through... for camera-pose grads rays must be a function of
        # the pose, so recompute directions from pose-relative offsets:
        # we store per-ray *pixel* dirs in camera frame instead. Simpler:
        # the caller passes camera-frame ray dirs; rotate here.
        o_world, d_world = _world_rays(cam_p, o_s, d_s)
        if use_custom_vjp:
            from vxtpu.render.vjp import render_soft_rays_fast

            pred = render_soft_rays_fast(soft, o_world, d_world, settings,
                                         num_samples, lights, mask,
                                         mask_scale, bounds)
        else:
            pred, _ = render_soft_rays(soft, o_world, d_world, settings,
                                       num_samples, lights, mask=mask,
                                       mask_scale=mask_scale,
                                       seg_bounds=bounds)
        # mean over ALL rays: local sum / n_total, then psum
        return jnp.sum((pred - tgt_s) ** 2) / (n_total * 3.0)

    mask_spec = (P(), P(RAY_AXIS), P(RAY_AXIS)) if use_mask else ()

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS),
                  *mask_spec),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    def _step(soft, cam, opt_state, o_s, d_s, tgt_s, *mask_a):
        mask = mask_a[0] if use_mask else None
        n_local = o_s.shape[0]
        n_total = n_local * mesh.devices.size
        # grad_buckets is a tuning knob, not a shape constraint: fall back
        # to the largest divisor of n_local that is <= the requested count.
        B = max(1, min(grad_buckets, n_local))
        while n_local % B != 0:
            B -= 1
        nb = n_local // B

        loss = jnp.float32(0.0)
        grads = None
        # Unrolled so each bucket's psum is an independent HLO collective
        # that can launch while later buckets' backward is still running.
        for b in range(B):
            sl = slice(b * nb, (b + 1) * nb)

            def lf(params, sl=sl):
                s, c = params
                b = ((mask_a[1][sl], mask_a[2][sl]) if use_mask else None)
                return _local_loss(s, c, o_s[sl], d_s[sl], tgt_s[sl],
                                   n_total, mask, b)

            loss_b, g_b = jax.value_and_grad(lf)((soft, cam))
            g_b = jax.lax.psum(g_b, RAY_AXIS)     # in flight during bucket b+1
            loss = loss + jax.lax.psum(loss_b, RAY_AXIS)
            grads = g_b if grads is None else jax.tree_util.tree_map(
                jnp.add, grads, g_b)
        gs, gc = grads
        soft_state, cam_state = opt_state
        upd, soft_state = opt.update(gs, soft_state, soft)
        soft = jax.tree_util.tree_map(lambda p, u: p + u, soft, upd)
        if optimize_camera:
            cupd, cam_state = cam_opt.update(gc, cam_state, cam)
            cam = jax.tree_util.tree_map(lambda p, u: p + u, cam, cupd)
        return soft, cam, (soft_state, cam_state), loss

    # donate the training carry: without donation old + new params and
    # both adam-moment generations coexist across the update
    return init_fn, jax.jit(_step, donate_argnums=(0, 2))


def camera_frame_rays(cam: Camera, height: int, width: int):
    """Rays in CAMERA-relative form for the sharded train step: origins are
    zero offsets, dirs are camera-frame unit vectors [fwd, right, up] basis
    coefficients. Rotating/translating back inside the step keeps the pose
    differentiable while the precomputed arrays stay static."""
    o, d = generate_rays(cam, height, width)
    fwd, right, up = cam.basis()
    R = jnp.stack([fwd, right, up], axis=1)
    d_cam = d @ R          # world->cam coefficients
    return jnp.zeros_like(o), d_cam


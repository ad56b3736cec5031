"""March-implementation-agnostic render pipeline: primary march -> shadow
marches -> shade -> image. The analog of the reference's per-frame
``CLCaster::compute()`` dispatch (SURVEY.md §4.2), except the "kernel" is a
composition of pure functions and XLA fuses the lot.

Every march kernel (oracle / Triton / XLA) plugs in through the same
``march(o, d, t_max=None) -> HitRecord`` closure, so shadows and shading are
structurally identical across implementations — parity tests then isolate
the march itself.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vxtpu.camera.camera import Camera
from vxtpu.camera.rays import generate_rays
from vxtpu.render.settings import RenderSettings
from vxtpu.render.shade import shade, _SHADOW_EPS
from vxtpu.world.grid import VoxelGrid
from vxtpu.world.lights import Lights


def shadow_visibility(march, rec, o, d, lights: Lights):
    """[N, L] visibility: 1.0 where the path from the hit point to each light
    is unoccluded. One extra march per light (the reference does the same
    second shorter DDA loop per light inside its kernel, SURVEY.md §4.3).
    Misses (no primary hit) get visibility 1 — they're sky, never shaded.
    """
    n = o.shape[0]
    p = o + rec.t[..., None] * d + rec.normal * _SHADOW_EPS
    vis_cols = []
    for li in range(lights.count):
        lvec = lights.pos[li][None, :] - p                     # [N,3]
        dist = jnp.linalg.norm(lvec, axis=-1)
        ldir = lvec / jnp.maximum(dist, 1e-12)[..., None]
        srec = march(p, ldir, t_max=dist - 2.0 * _SHADOW_EPS)
        vis_cols.append(jnp.where(srec.hit & rec.hit, 0.0, 1.0))
    if not vis_cols:
        return jnp.ones((n, 0), jnp.float32)
    return jnp.stack(vis_cols, axis=-1)


def render_rays(march, o, d, albedo_src, dims, lights: Lights,
                settings: RenderSettings, atlas=None, material_ids=None):
    """Rays [N,3] -> rgb [N,3] via the given march closure."""
    rec = march(o, d)
    vis = None
    if settings.shadows and settings.shading != "flat" and lights.count > 0:
        vis = shadow_visibility(march, rec, o, d, lights)
    rgb = shade(rec, o, d, albedo_src, dims, lights, settings,
                shadow_vis=vis, atlas=atlas, material_ids=material_ids)
    return rgb, rec


def render_image(march_factory, grid: VoxelGrid, cam: Camera, lights: Lights,
                 settings: RenderSettings, height: int, width: int,
                 accel=None, atlas=None) -> jax.Array:
    """Full frame: [H, W, 3] float32 in [0,1].

    march_factory(occ_flat, dims, settings, accel) -> march closure;
    accel is an OccupancyPyramid, a DistanceField, or None;
    atlas an optional TextureAtlas (face-textured hits, C17).
    """
    dims = grid.dims
    occ_flat = grid.occupancy.reshape(-1)
    march = march_factory(occ_flat, dims, settings, accel)
    o, d = generate_rays(cam, height, width)
    rgb, _ = render_rays(march, o, d, grid.albedo(), dims, lights, settings,
                         atlas=atlas, material_ids=occ_flat)
    return rgb.reshape(height, width, 3)

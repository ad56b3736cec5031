"""Shading: everything after the march hit — face-normal lighting, shadows,
fog, sky. The rebuild of the tail of the reference's OpenCL kernel
(SURVEY.md §4.3: normal from step mask, diffuse+specular per light, shadow
ray, fog mix, sky on miss), expressed as pure batched elementwise math over the
HitRecord so every march implementation shades identically.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vxtpu.render.settings import RenderSettings
from vxtpu.render.types import HitRecord
from vxtpu.world.grid import linear_index
from vxtpu.world.lights import Lights

_SHADOW_EPS = 1e-3


def sky_color(d: jax.Array, settings: RenderSettings) -> jax.Array:
    """Vertical gradient sky: d [N,3] -> rgb [N,3]."""
    top = jnp.asarray(settings.sky_top, jnp.float32)
    hor = jnp.asarray(settings.sky_horizon, jnp.float32)
    u = jnp.clip(d[..., 2] * 0.5 + 0.5, 0.0, 1.0)[..., None]
    return hor * (1.0 - u) + top * u


def flat_shade(albedo: jax.Array, normal: jax.Array) -> jax.Array:
    """Config-1 shading: albedo scaled by a per-face brightness so geometry
    reads without any lights (the classic voxel-engine face tint)."""
    w = jnp.asarray([0.80, 0.68, 1.00], jnp.float32)  # x, y, z faces
    axis_w = jnp.sum(jnp.abs(normal) * w, axis=-1)
    # bottom faces darker than top
    axis_w = jnp.where(normal[..., 2] < -0.5, 0.45, axis_w)
    return albedo * axis_w[..., None]


def lit_shade(albedo, p, normal, view_dir, lights: Lights,
              shadow_vis, settings: RenderSettings):
    """Diffuse (+ optional Blinn-Phong specular) from L point lights.

    p: hit points [N,3]; shadow_vis: [N,L] in [0,1] (1 = unoccluded) or None.
    """
    acc = albedo * settings.ambient
    if lights.count == 0:
        return acc
    lvec = lights.pos[None, :, :] - p[:, None, :]          # [N,L,3]
    dist2 = jnp.sum(lvec * lvec, axis=-1)                   # [N,L]
    ldir = lvec * jax.lax.rsqrt(jnp.maximum(dist2, 1e-12))[..., None]
    ndotl = jnp.maximum(jnp.sum(normal[:, None, :] * ldir, axis=-1), 0.0)  # [N,L]
    atten = lights.intensity[None, :] / (1.0 + 0.002 * dist2)
    vis = shadow_vis if shadow_vis is not None else jnp.ones_like(ndotl)
    diff = ndotl * atten * vis                              # [N,L]
    acc = acc + albedo * jnp.sum(diff[..., None] * lights.rgb[None, :, :], axis=1)
    if settings.shading == "full":
        h = ldir - view_dir[:, None, :]                     # L + V (V = -view_dir)
        h = h * jax.lax.rsqrt(jnp.maximum(jnp.sum(h * h, axis=-1), 1e-12))[..., None]
        ndoth = jnp.maximum(jnp.sum(normal[:, None, :] * h, axis=-1), 0.0)
        spec = settings.specular_k * (ndoth ** settings.specular_exp)
        spec = spec * (ndotl > 0.0) * atten * vis
        acc = acc + jnp.sum(spec[..., None] * lights.rgb[None, :, :], axis=1)
    return acc


def apply_fog(rgb, t, d, hit, settings: RenderSettings):
    """Exponential distance fog toward the sky color of each ray."""
    fog_f = 1.0 - jnp.exp(-settings.fog_density * t)
    fog_f = jnp.where(hit, fog_f, 0.0)[..., None]
    return rgb * (1.0 - fog_f) + sky_color(d, settings) * fog_f


def shade(rec: HitRecord, o, d, albedo_src, dims, lights: Lights,
          settings: RenderSettings, shadow_vis=None, atlas=None,
          material_ids=None) -> jax.Array:
    """Full shading dispatch: HitRecord [N] -> rgb [N,3] in [0,1].

    albedo_src: world.grid.Albedo (1D-gather color source, one plane per
    channel).
    atlas: optional world.atlas.TextureAtlas — when given, the hit color
    comes from the face texture (sampled at the hit point; the reference
    sampled its atlas image2d the same way, SURVEY.md §3 C17) instead of
    the flat per-voxel albedo. material_ids: uint8 [X*Y*Z] ids for atlas
    row selection (defaults to albedo_src.ids when palette-mode).
    """
    idx = jnp.clip(linear_index(rec.voxel, dims), 0, albedo_src.size - 1)
    albedo = albedo_src.at(idx)
    if atlas is not None:
        from vxtpu.world.atlas import sample_atlas

        ids_flat = material_ids if material_ids is not None else albedo_src.ids
        if ids_flat is None:
            raise ValueError("atlas shading needs material ids "
                             "(palette-mode albedo or material_ids=)")
        mat = jnp.take(ids_flat, idx, axis=0)
        p_hit = o + rec.t[..., None] * d
        albedo = jnp.where(rec.hit[..., None],
                           sample_atlas(atlas, mat, p_hit, rec.normal),
                           albedo)
    if settings.shading == "flat":
        rgb = flat_shade(albedo, rec.normal)
    else:
        p = o + rec.t[..., None] * d + rec.normal * _SHADOW_EPS
        rgb = lit_shade(albedo, p, rec.normal, d, lights, shadow_vis, settings)
    if settings.fog:
        rgb = apply_fog(rgb, rec.t, d, rec.hit, settings)
    rgb = jnp.where(rec.hit[..., None], rgb, sky_color(d, settings))
    return jnp.clip(rgb, 0.0, 1.0)

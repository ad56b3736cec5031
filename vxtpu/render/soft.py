"""Differentiable volumetric ("soft") render mode — BASELINE.json config 4.

The reference renderer is hard-surface only; differentiability is a new,
normative capability ("custom VJP that backpropagates pixel-loss gradients
to voxel colors/densities and camera pose"). Design follows the Plenoxels
/ occupancy-grid-NeRF pattern (SURVEY.md §8, PAPERS.md): the scene is a
density grid sigma [X,Y,Z] + color grid rgb [X,Y,Z,3]; a ray accumulates

    alpha_i = 1 - exp(-softplus(sigma_i) * dt_i)
    T_i     = prod_{j<i} (1 - alpha_j)
    C       = sum_i T_i alpha_i c_i + T_end * sky

with trilinearly-interpolated sigma/rgb at S uniform samples on the ray's
grid-clipped segment. Everything is jnp; gradients to sigma, rgb AND the
camera pose (through the sample positions) come from autodiff. This module
is the REFERENCE semantics: the O(N_rays + grid) custom-VJP fast path
(render/vjp.py) must match it to allclose (tests/test_vjp.py).

Voxel-center convention: the value stored at index (i,j,k) lives at world
point (i+.5, j+.5, k+.5) — interpolation is over neighboring centers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vxtpu.render import dda
from vxtpu.render.settings import RenderSettings
from vxtpu.render.shade import sky_color
from vxtpu.utils import pytree_dataclass


@pytree_dataclass
class SoftGrid:
    """Optimizable scene: raw (pre-softplus) densities + rgb logits.

    sigma_raw: float32 [X,Y,Z]   — softplus'd into nonneg density.
    rgb_raw:   float32 [3,X,Y,Z] — sigmoid'd into [0,1] color.

    Color is stored channel-major: each channel is one contiguous plane,
    so a trilinear fetch gathers from one [X,Y,Z] plane per channel.
    """

    sigma_raw: jax.Array
    rgb_raw: jax.Array

    @property
    def dims(self) -> tuple[int, int, int]:
        return tuple(self.sigma_raw.shape)  # type: ignore[return-value]

    @staticmethod
    def zeros(dims: tuple[int, int, int]) -> "SoftGrid":
        return SoftGrid(
            sigma_raw=jnp.full(dims, -2.0, jnp.float32),
            rgb_raw=jnp.zeros((3, *dims), jnp.float32),
        )

    @staticmethod
    def from_hard(grid, sigma_solid: float = 40.0) -> "SoftGrid":
        """Initialize from a hard VoxelGrid (solid voxels -> high density).

        Empty voxels inherit the mean color of neighboring solid voxels
        (two dilation passes): trilinear sampling at a surface mixes the
        solid center with the adjacent empty center, so leaving empties
        black would darken every surface sample. All math is per-channel
        [X,Y,Z] planes (no [...,3] minor dim — see the class docstring).
        """
        from vxtpu.world.grid import MATERIAL_RGB

        occ = (grid.occupancy > 0)
        sigma_raw = jnp.where(occ, sigma_solid, -6.0).astype(jnp.float32)
        if grid.rgb is not None:
            chans = [grid.rgb[..., c] for c in range(3)]
        else:
            ids = jnp.minimum(grid.occupancy.astype(jnp.int32),
                              MATERIAL_RGB.shape[0] - 1)
            chans = [jnp.take(MATERIAL_RGB[:, c], ids, axis=0)
                     for c in range(3)]

        w = occ.astype(jnp.float32)
        cols = [c * w for c in chans]
        for _ in range(2):
            wsum = jnp.zeros_like(w)
            csums = [jnp.zeros_like(c) for c in cols]
            for ax in range(3):
                for sh in (1, -1):
                    wsum = wsum + jnp.roll(w, sh, axis=ax)
                    csums = [cs + jnp.roll(c, sh, axis=ax)
                             for cs, c in zip(csums, cols)]
            filled = wsum > 0
            denom = jnp.maximum(wsum, 1)
            cols = [jnp.where(w > 0, c,
                              jnp.where(filled, cs / denom, c))
                    for c, cs in zip(cols, csums)]
            w = jnp.maximum(w, filled.astype(jnp.float32))

        logit = [jnp.log(jnp.clip(c, 1e-3, 1.0 - 1e-3))
                 - jnp.log1p(-jnp.clip(c, 1e-3, 1.0 - 1e-3)) for c in cols]
        return SoftGrid(sigma_raw=sigma_raw,
                        rgb_raw=jnp.stack(logit, axis=0))


def trilinear_grad(values: jax.Array, p: jax.Array,
                   dims: tuple[int, int, int]) -> jax.Array:
    """Spatial gradient [..., 3] of the trilinear field of ``values``
    ([X,Y,Z]) at world points p — analytic derivative of the interpolation
    basis, reusing the same 8 corner fetches as trilinear() (no extra
    memory traffic beyond them).

    Used for density-gradient normals in lit soft mode: the soft analog of
    the hard pipeline's DDA face normals (SURVEY.md §4.3 "normal from step
    mask"). Note the derivative is piecewise-constant per cell (exactly the
    trilinear basis derivative), which is what autodiff through trilinear()
    would produce too.
    """
    q = p - 0.5
    q0 = jnp.floor(q)
    f = q - q0
    i0 = jnp.clip(q0.astype(jnp.int32), 0, jnp.asarray(dims, jnp.int32) - 1)
    i1 = jnp.clip(i0 + 1, 0, jnp.asarray(dims, jnp.int32) - 1)
    X, Y, Z = dims
    flat = values.reshape(-1)

    def g(ix, iy, iz):
        return jnp.take(flat, (ix * Y + iy) * Z + iz, axis=0)

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c000 = g(i0[..., 0], i0[..., 1], i0[..., 2])
    c001 = g(i0[..., 0], i0[..., 1], i1[..., 2])
    c010 = g(i0[..., 0], i1[..., 1], i0[..., 2])
    c011 = g(i0[..., 0], i1[..., 1], i1[..., 2])
    c100 = g(i1[..., 0], i0[..., 1], i0[..., 2])
    c101 = g(i1[..., 0], i0[..., 1], i1[..., 2])
    c110 = g(i1[..., 0], i1[..., 1], i0[..., 2])
    c111 = g(i1[..., 0], i1[..., 1], i1[..., 2])
    gx = (((c100 - c000) * (1 - fy) + (c110 - c010) * fy) * (1 - fz)
          + ((c101 - c001) * (1 - fy) + (c111 - c011) * fy) * fz)
    gy = (((c010 - c000) * (1 - fx) + (c110 - c100) * fx) * (1 - fz)
          + ((c011 - c001) * (1 - fx) + (c111 - c101) * fx) * fz)
    gz = (((c001 - c000) * (1 - fx) + (c101 - c100) * fx) * (1 - fy)
          + ((c011 - c010) * (1 - fx) + (c111 - c110) * fx) * fy)
    return jnp.stack([gx, gy, gz], axis=-1)


def trilinear(values: jax.Array, p: jax.Array, dims: tuple[int, int, int]):
    """Trilinearly interpolate ``values`` ([X,Y,Z] scalar or [C,X,Y,Z]
    channel-major) at world points p [...,3] (voxel-center convention).
    Edge-clamped. Returns [...] for scalar fields, [..., C] otherwise."""
    q = p - 0.5  # center-grid coords
    q0 = jnp.floor(q)
    f = q - q0
    i0 = jnp.clip(q0.astype(jnp.int32), 0, jnp.asarray(dims, jnp.int32) - 1)
    i1 = jnp.clip(i0 + 1, 0, jnp.asarray(dims, jnp.int32) - 1)
    X, Y, Z = dims
    if values.ndim == 3:
        flats = (values.reshape(-1),)
    else:
        flats = tuple(values[c].reshape(-1)
                      for c in range(values.shape[0]))

    def g(ix, iy, iz):
        idx = (ix * Y + iy) * Z + iz
        return jnp.stack([jnp.take(fl, idx, axis=0) for fl in flats],
                         axis=-1)

    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    c000 = g(i0[..., 0], i0[..., 1], i0[..., 2])
    c001 = g(i0[..., 0], i0[..., 1], i1[..., 2])
    c010 = g(i0[..., 0], i1[..., 1], i0[..., 2])
    c011 = g(i0[..., 0], i1[..., 1], i1[..., 2])
    c100 = g(i1[..., 0], i0[..., 1], i0[..., 2])
    c101 = g(i1[..., 0], i0[..., 1], i1[..., 2])
    c110 = g(i1[..., 0], i1[..., 1], i0[..., 2])
    c111 = g(i1[..., 0], i1[..., 1], i1[..., 2])
    c00 = c000 * (1 - fz) + c001 * fz
    c01 = c010 * (1 - fz) + c011 * fz
    c10 = c100 * (1 - fz) + c101 * fz
    c11 = c110 * (1 - fz) + c111 * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    out = c0 * (1 - fx) + c1 * fx
    if values.ndim == 3:
        return out[..., 0]
    return out


def shade_samples(c_raw: jax.Array, grad_raw: jax.Array, p: jax.Array,
                  view_dir: jax.Array, lights, settings: RenderSettings):
    """Lambert (+ Blinn-Phong for shading='full') lighting of volume
    samples with density-gradient normals — the lit soft mode, so config
    4/5 optimization targets resemble the hard render ladder's look
    (configs 2-3) instead of flat emission.

    c_raw:    [..., 3] base sample color (sigmoid'd rgb field).
    grad_raw: [..., 3] spatial gradient of the RAW sigma field at p —
              softplus' > 0 preserves direction, so the unit normal is
              -normalize(grad_raw), no softplus chain needed.
    view_dir: [..., 3] ray direction (broadcastable against p).
    """
    g2 = jnp.sum(grad_raw * grad_raw, axis=-1, keepdims=True)
    n = -grad_raw * jax.lax.rsqrt(g2 + 1e-9)                    # [..., 3]
    acc_l = jnp.full(c_raw.shape[:-1] + (1,), settings.ambient, c_raw.dtype)
    lvec = lights.pos - p[..., None, :]                         # [..., L, 3]
    dist2 = jnp.sum(lvec * lvec, axis=-1)                       # [..., L]
    ldir = lvec * jax.lax.rsqrt(jnp.maximum(dist2, 1e-12))[..., None]
    ndotl = jnp.maximum(jnp.sum(n[..., None, :] * ldir, axis=-1), 0.0)
    atten = lights.intensity / (1.0 + 0.002 * dist2)
    diff = ndotl * atten                                        # [..., L]
    out = c_raw * (acc_l + jnp.sum(diff[..., None] * lights.rgb, axis=-2))
    if settings.shading == "full":
        h = ldir - view_dir[..., None, :]
        h = h * jax.lax.rsqrt(jnp.maximum(jnp.sum(h * h, axis=-1),
                                          1e-12))[..., None]
        ndoth = jnp.maximum(jnp.sum(n[..., None, :] * h, axis=-1), 0.0)
        spec = settings.specular_k * (ndoth ** settings.specular_exp)
        spec = spec * (ndotl > 0.0) * atten
        out = out + jnp.sum(spec[..., None] * lights.rgb, axis=-2)
    return out


_warned_scope: set = set()


def warn_soft_scope(settings: RenderSettings, lights) -> None:
    """Soft mode's documented scope cuts fail LOUDLY instead of silently:
    shadow marches / fog are hard-pipeline-only, and
    lit shading needs lights."""
    import warnings

    lit_requested = settings.shading != "flat"
    have_lights = lights is not None and getattr(lights, "count", 0) > 0
    key = (settings.shadows, settings.fog, lit_requested and not have_lights)
    if key in _warned_scope:
        return
    _warned_scope.add(key)
    if settings.shadows or settings.fog:
        warnings.warn(
            "soft (volumetric) render mode does not implement shadow "
            "marches or fog; settings.shadows/settings.fog are ignored "
            "here (hard-render pipeline only)", stacklevel=3)
    if lit_requested and not have_lights:
        warnings.warn(
            f"soft render with shading={settings.shading!r} but no lights: "
            "falling back to emission shading — pass lights= for the lit "
            "soft mode", stacklevel=3)


def render_soft_rays(soft: SoftGrid, o: jax.Array, d: jax.Array,
                     settings: RenderSettings, num_samples: int,
                     lights=None, mask=None, mask_scale: int = 4,
                     seg_bounds=None):
    """Volumetric render of rays [N,3] -> (rgb [N,3], aux dict).

    Uniform sampling over each ray's clipped [t_enter, t_exit] segment;
    rays missing the grid get pure sky. Fully differentiable (autodiff) —
    this IS the reference semantics for the custom-VJP fast path.

    lights: optional world.lights.Lights — when given (and settings.shading
    is 'lambert'/'full'), samples are lit via density-gradient normals
    (shade_samples); None keeps the emission-only mode.

    mask: optional coarse occupancy mask uint8 [X/G, Y/G, Z/G] (G =
    mask_scale) — the MASKED soft model (render/occmask.py): effective
    density is zero outside occupied mask cells (a pointwise multiply
    here; the fast path exploits it to skip empty space exactly).
    seg_bounds: optional (t0, t1) per-ray sample-segment override
    (occmask.mask_segment_bounds) — treated as NON-differentiable
    constants (stop_gradient), so autodiff through this reference defines
    the same quadrature-sense gradient as the custom VJP.
    """
    dims = soft.dims
    warn_soft_scope(settings, lights)
    t_enter, t_exit, valid = dda.ray_grid_clip(o, d, dims)
    if seg_bounds is not None:
        t0 = jax.lax.stop_gradient(
            jnp.maximum(seg_bounds[0], t_enter))
        t1 = jax.lax.stop_gradient(
            jnp.minimum(seg_bounds[1], t_exit))
        seg = jnp.maximum(t1 - t0, 0.0)
        start = t0
    else:
        seg = jnp.maximum(t_exit - t_enter, 0.0)
        start = t_enter
    dt = seg / num_samples                                   # [N]
    s_idx = jnp.arange(num_samples, dtype=o.dtype) + 0.5     # [S]
    t_s = start[:, None] + dt[:, None] * s_idx[None, :]      # [N,S]
    p = o[:, None, :] + t_s[..., None] * d[:, None, :]       # [N,S,3]

    sigma = jax.nn.softplus(trilinear(soft.sigma_raw, p, dims))     # [N,S]
    if mask is not None:
        from vxtpu.render.occmask import mask_at

        sigma = sigma * mask_at(mask, mask_scale, p)
    rgb = jax.nn.sigmoid(trilinear(soft.rgb_raw, p, dims))          # [N,S,3]
    if (lights is not None and lights.count > 0
            and settings.shading != "flat"):
        grad_raw = trilinear_grad(soft.sigma_raw, p, dims)          # [N,S,3]
        rgb = shade_samples(rgb, grad_raw, p, d[:, None, :], lights,
                            settings)

    alpha = 1.0 - jnp.exp(-sigma * dt[:, None])              # [N,S]
    alpha = jnp.where(valid[:, None], alpha, 0.0)
    # exclusive cumprod of (1-alpha) via SHIFT, never division: the
    # division form divides by EXACTLY zero at saturated samples under
    # jit on device (XLA reassociates (1 - alpha + eps) into
    # ((1 + eps) - alpha) == 0.0f when alpha == 1 — same trap as
    # render/vjp.py's suffix denominator)
    one_m = 1.0 - alpha + 1e-10
    T = jnp.cumprod(
        jnp.concatenate([jnp.ones_like(one_m[:, :1]), one_m[:, :-1]],
                        axis=1), axis=1)                     # exclusive
    w = T * alpha                                            # [N,S]
    color = jnp.sum(w[..., None] * rgb, axis=1)              # [N,3]
    T_end = jnp.prod(one_m, axis=1)
    color = color + T_end[..., None] * sky_color(d, settings)
    aux = dict(weights=w, t=t_s, transmittance_end=T_end, opacity=1.0 - T_end)
    return color, aux


def render_soft_image(soft: SoftGrid, cam, settings: RenderSettings,
                      height: int, width: int, num_samples: int,
                      lights=None):
    """[H,W,3] differentiable render (grads flow to soft grid AND cam pose).
    ``lights`` enables the lit soft mode (see render_soft_rays)."""
    from vxtpu.camera.rays import generate_rays

    o, d = generate_rays(cam, height, width)
    rgb, _ = render_soft_rays(soft, o, d, settings, num_samples, lights)
    return rgb.reshape(height, width, 3)

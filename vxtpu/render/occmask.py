"""Occupancy-grid sample skipping for the differentiable soft renderer —
the PAPERS P:5,P:9 occupancy-grid-NeRF pattern: most of config 4/5's uniform samples land in provably empty
space; a coarse occupancy MASK makes that emptiness part of the model so
the sampler may skip it EXACTLY.

Semantics (the "masked soft model"): effective density at world point p is

    sigma(p) = softplus(sigma_raw)(p) * mask[floor(p) // G]

i.e. density is identically ZERO outside occupied mask cells. Two exact
consequences:
  * the reference renderer only needs a pointwise mask multiply
    (render/soft.render_soft_rays(mask=...));
  * restricting each ray's sample segment to [t0, t1] — its first/last
    intersection with occupied mask cells — changes NOTHING (transmittance
    is constant across zero-density space), so S samples concentrate in
    the occupied band: the same in-band sample spacing needs ~4-8x fewer
    samples, which is the train-step speedup (bench train_step_masked).

The bounds are non-differentiable by construction (the integrand is zero
at both boundary points, so dL/dt0 = dL/dt1 = 0 — stop_gradient is
mathematically exact, not an approximation).

During training the mask is REFRESHED periodically from the current
density field (threshold + 1-cell dilation, all-ones to start) — the
instant-ngp/Plenoxels occupancy-update loop.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vxtpu.render import dda
from vxtpu.world.distfield import build_distance_field


def occupancy_mask_from_soft(soft, scale: int = 4, tau: float = 0.01,
                             dilate: int = 1) -> jax.Array:
    """uint8 [X/G, Y/G, Z/G] mask from the current density field: a mask
    cell is occupied iff any of its G^3 voxels has softplus(sigma_raw) >
    tau, then dilated ``dilate`` cells (conservative: trains densities
    just outside the current surface)."""
    X, Y, Z = soft.dims
    G = scale
    assert X % G == 0 and Y % G == 0 and Z % G == 0
    occ = (jax.nn.softplus(soft.sigma_raw) > tau)
    m = occ.reshape(X // G, G, Y // G, G, Z // G, G).any(axis=(1, 3, 5))
    for _ in range(dilate):
        grown = m
        for ax in range(3):
            for sh in (1, -1):
                grown = grown | jnp.roll(m, sh, axis=ax)
        # roll wraps; un-wrap by masking the wrapped border is overkill for
        # a conservative mask — wrapping only ever ADDS occupied cells
        m = grown
    return m.astype(jnp.uint8)


def mask_all_ones(dims, scale: int = 4) -> jax.Array:
    return jnp.ones((dims[0] // scale, dims[1] // scale, dims[2] // scale),
                    jnp.uint8)


def mask_at(mask: jax.Array, scale: int, p: jax.Array) -> jax.Array:
    """Nearest-cell mask value (0/1 float) at world points p [..., 3].
    Out-of-grid points CLAMP to the nearest border cell (and read its
    value) — callers only evaluate inside the AABB, where the clamp is a
    no-op; do not rely on this reading zero beyond the grid."""
    md = jnp.asarray(mask.shape, jnp.int32)
    ci = jnp.clip(jnp.floor(p / scale).astype(jnp.int32), 0, md - 1)
    Xc, Yc, Zc = mask.shape
    idx = (ci[..., 0] * Yc + ci[..., 1]) * Zc + ci[..., 2]
    return jnp.take(mask.reshape(-1), idx, axis=0).astype(jnp.float32)


def mask_distance_field(mask: jax.Array) -> jax.Array:
    """Flat distance field of the mask grid. Precompute this ONCE per
    mask refresh and pass it to mask_segment_bounds rather than building
    it inside every train step."""
    md = tuple(int(x) for x in mask.shape)
    return build_distance_field(mask.astype(jnp.uint8),
                                cap=max(md)).reshape(-1)


def mask_segment_bounds(mask: jax.Array, scale: int, o: jax.Array,
                        d: jax.Array, df_flat: jax.Array | None = None):
    """(t0, t1) per ray: conservative entry/exit of the occupied-mask-cell
    band along each ray, in WORLD units. Rays touching no occupied cell
    get t0 == t1 (zero-length segment -> pure sky). NON-differentiable
    (stop_gradient'd inputs): exact, because density is zero at and
    outside both bounds under the masked model.

    Implementation: the existing distance-field hard march over the mask
    grid (render/kernel_xla.march_xla_df), run forward from the ray origin
    and backward from beyond the far end — empty-space jumps make this a
    handful of gathers per ray, not O(dims) steps.
    """
    from vxtpu.render.kernel_xla import march_xla_df

    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    G = float(scale)
    md = tuple(int(x) for x in mask.shape)
    if df_flat is None:
        df_flat = mask_distance_field(mask)
    max_steps = sum(md) + 2

    om = o / G                                 # mask-grid coordinates
    t_enter_m, t_exit_m, valid = dda.ray_grid_clip(om, d, md)

    fwd = march_xla_df(om, d, df_flat, md, max_steps)
    # backward march from just beyond the exit point, along -d: the first
    # hit is the LAST occupied cell on the ray; its hit t (in backward
    # parameterization) converts to the forward exit bound.
    o_back = om + (t_exit_m[:, None] + 1.0) * d
    bwd = march_xla_df(o_back, -d, df_flat, md, max_steps)

    hit_any = fwd.hit & bwd.hit & valid
    t0_m = jnp.where(hit_any, fwd.t, 0.0)
    t1_m = jnp.where(hit_any, (t_exit_m + 1.0) - bwd.t, 0.0)
    t0 = G * t0_m
    t1 = jnp.maximum(G * t1_m, t0)
    return t0, t1

"""Shared 3D-DDA primitives (Amanatides & Woo traversal) used identically by
the per-ray oracle (render/kernel_ref) and the batched XLA march
(render/kernel_xla); the Triton march (render/kernel_triton) restates them
per axis — so all paths compute the same
quantities and parity is bit-honest.

This is the rebuild of the reference kernel's traversal setup
(SURVEY.md §4.3: ``delta_t = fabs(1/dir)``, per-axis ``intersection_t``,
step the axis with smallest t). Everything here is shape-polymorphic over a
leading batch: pass [3] arrays for one ray or [..., 3] for a batch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vxtpu.utils import safe_inverse

# Nudge into the grid after the entry-plane intersection so floor() lands in
# the first interior voxel rather than on the boundary.
ENTRY_EPS = jnp.float32(1e-4)


def ray_grid_clip(o: jax.Array, d: jax.Array, dims: tuple[int, int, int]):
    """Slab-test the ray against the grid AABB [0,X]x[0,Y]x[0,Z].

    Returns (t_enter, t_exit, valid): enter/exit params (t_enter >= 0) and a
    bool mask; rays starting inside get t_enter = 0.
    """
    inv = safe_inverse(d)
    bmax = jnp.asarray(dims, dtype=o.dtype)
    t0 = (0.0 - o) * inv
    t1 = (bmax - o) * inv
    tnear = jnp.minimum(t0, t1)
    tfar = jnp.maximum(t0, t1)
    t_enter = jnp.maximum(jnp.max(tnear, axis=-1), 0.0)
    t_exit = jnp.min(tfar, axis=-1)
    valid = t_enter <= t_exit
    return t_enter, t_exit, valid


def dda_init(o: jax.Array, d: jax.Array, t_start: jax.Array, dims: tuple[int, int, int]):
    """Initialize DDA state at parameter t_start (entry point or restart point).

    Returns (voxel int32 [...,3], t_next float [...,3], t_delta float [...,3],
    step int32 [...,3]).

    t_next[a] = ray parameter at which the ray crosses the *next* boundary of
    axis a; t_delta[a] = parameter distance between successive a-boundaries.
    """
    p = o + (t_start + ENTRY_EPS)[..., None] * d
    dims_a = jnp.asarray(dims, dtype=o.dtype)
    v = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, jnp.asarray(dims, jnp.int32) - 1)
    inv = safe_inverse(d)
    step = jnp.where(d >= 0, 1, -1).astype(jnp.int32)
    # boundary coordinate the ray will hit next on each axis
    next_bound = jnp.where(d >= 0, v.astype(o.dtype) + 1.0, v.astype(o.dtype))
    t_next = (next_bound - o) * inv
    t_delta = jnp.abs(inv)
    # Degenerate axes (d == 0): never cross — push t_next to +inf-ish.
    t_next = jnp.where(jnp.abs(d) < 1e-12, jnp.full_like(t_next, 3.0e30), t_next)
    del dims_a
    return v, t_next, t_delta, step


def dda_step_mask(t_next: jax.Array) -> jax.Array:
    """Bool [...,3] mask selecting the axis with smallest t_next (ties step
    the lower-index axis only, so every path takes identical cell sequences).
    """
    tmin = jnp.min(t_next, axis=-1, keepdims=True)
    is_min = t_next <= tmin
    # break ties: keep the first True along the last axis
    cum = jnp.cumsum(is_min.astype(jnp.int32), axis=-1)
    return is_min & (cum == 1)


def dda_advance(v, t_next, t_delta, step):
    """One DDA step. Returns (v', t_next', t_cross, mask) where t_cross is the
    ray parameter at which the boundary was crossed (entry t of the new voxel)
    and mask is the stepped-axis one-hot (the face normal source).
    """
    mask = dda_step_mask(t_next)
    t_cross = jnp.min(t_next, axis=-1)
    v2 = v + jnp.where(mask, step, 0)
    t_next2 = t_next + jnp.where(mask, t_delta, jnp.zeros_like(t_delta))
    return v2, t_next2, t_cross, mask


def entry_face_mask(o: jax.Array, d: jax.Array, dims: tuple[int, int, int]):
    """One-hot [...,3] axis mask of the AABB face crossed at t_enter (for the
    normal when the *first* voxel is already solid): the axis whose near-slab
    t is largest. Rays starting inside the grid get a deterministic axis
    (ties break to the lowest axis, same rule as dda_step_mask).
    """
    inv = safe_inverse(d)
    bmax = jnp.asarray(dims, dtype=o.dtype)
    tnear = jnp.minimum((0.0 - o) * inv, (bmax - o) * inv)
    tmax = jnp.max(tnear, axis=-1, keepdims=True)
    is_max = tnear >= tmax
    cum = jnp.cumsum(is_max.astype(jnp.int32), axis=-1)
    return is_max & (cum == 1)


def face_normal(mask: jax.Array, step: jax.Array) -> jax.Array:
    """Outward face normal of the voxel entered through the masked axis:
    the ray stepped +1 on axis a -> it entered through the -a face -> normal
    is -step on that axis. float32 [...,3].
    """
    return jnp.where(mask, -step, 0).astype(jnp.float32)

"""Chebyshev distance-field acceleration structure ("proximity clouds").

The reference accelerates its march with an SVO descent (SURVEY.md §3 C3);
the first rebuild used a dense occupancy pyramid (world/pyramid.py).
This module is the faster second-generation structure: a single uint8 field

    dfield[v] = 0                         if voxel v is solid
              = min(L_inf distance to the nearest solid voxel, cap)   else

One gather per march step yields BOTH the hit test (value == 0) and the
safe skip radius: every voxel u with ||u - v||_inf <= dfield[v] - 1 is
provably empty, so the ray can jump straight to the exit of the box
[v - (d-1), v + d] in world units without testing any voxel inside.
Versus the pyramid this cuts gathers per step from (levels+1) to 1 and
collapses long empty-space runs into a single jump, while remaining exactly
hit-equivalent to the plain fine DDA (jumps never cross a solid voxel).

Build is iterated separable 3-tap dilation: after k rounds, ``covered`` is
the occupancy dilated by a (2k+1)^3 cube, i.e. exactly the set of voxels at
L_inf distance <= k from a solid voxel — so the first round that covers a
voxel assigns its exact distance. Runs on-device; O(cap) fused
elementwise/roll passes, one-time per world edit (the analog of the
reference's CPU ``Octree::Generate`` rebuild).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vxtpu.utils import pytree_dataclass


@pytree_dataclass
class DistanceField:
    """Acceleration-structure pytree: the packed uint8 field [X,Y,Z]."""

    field: jax.Array

    @property
    def dims(self) -> tuple[int, int, int]:
        return tuple(self.field.shape)  # type: ignore[return-value]


def _dilate1(x: jax.Array) -> jax.Array:
    """3-tap max filter along each axis (separable cube dilation by 1).

    Edge handling: shifted-in cells are False — consistent with treating
    out-of-grid space as empty (rays exit the grid anyway).
    """
    for ax in range(3):
        lo = jnp.roll(x, 1, axis=ax).at[(slice(None),) * ax + (0,)].set(False)
        hi = jnp.roll(x, -1, axis=ax).at[(slice(None),) * ax + (-1,)].set(False)
        x = x | lo | hi
    return x


def build_distance_field(occupancy: jax.Array, cap: int = 24) -> jax.Array:
    """uint8 [X,Y,Z]: 0 where solid, else min(L_inf dist to solid, cap).

    cap bounds both build cost (cap dilation rounds) and the largest jump;
    distances beyond cap saturate (the march just jumps cap-1 and re-reads).
    """
    solid = occupancy > 0
    dist = jnp.where(solid, 0, cap).astype(jnp.uint8)
    covered = solid
    for k in range(1, cap):
        covered_k = _dilate1(covered)
        newly = covered_k & ~covered
        dist = jnp.where(newly, jnp.uint8(k), dist)
        covered = covered_k
    return dist


def build(occupancy: jax.Array, cap: int = 24) -> DistanceField:
    """Build the DistanceField accel structure for a grid's occupancy."""
    return DistanceField(field=build_distance_field(occupancy, cap))


def distfield_fetch(df_flat: jax.Array, v: jax.Array, dims: tuple[int, int, int]) -> jax.Array:
    """uint8 [N] field value at int voxel coords v [N,3].

    Out-of-bounds reads return 255 (maximal emptiness) — OOB voxels are
    never hits and the march's bounds check terminates those rays anyway.
    """
    from vxtpu.world.grid import in_bounds, linear_index

    ok = in_bounds(v, dims)
    idx = jnp.where(ok, linear_index(v, dims), 0)
    val = jnp.take(df_flat, idx, axis=0)
    return jnp.where(ok, val, jnp.full_like(val, 255))

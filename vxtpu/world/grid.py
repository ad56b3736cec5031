"""Voxel world as arrays (the replacement for the reference's
``map/Old_Map`` dense ``char*`` grid and ``map/Octree`` SVO — SURVEY.md §3
C2/C3). The grid is a pytree of device arrays, not an object graph: occupancy
(material id), optional per-voxel RGB, optional density for the soft
differentiable render mode (BASELINE.json config 4).

Coordinate convention (shared by every kernel in render/):
  * grid shape ``(X, Y, Z)``; voxel ``(i, j, k)`` occupies the world-space
    axis-aligned unit cube ``[i, i+1) x [j, j+1) x [k, k+1)``.
  * the whole grid spans ``[0,X] x [0,Y] x [0,Z]``; Z is "up" for terrain.
  * material id 0 means empty; ids >= 1 index ``MATERIAL_RGB``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vxtpu.utils import pytree_dataclass

# Material palette (id 0 = empty and never shaded). Mirrors the reference's
# terrain bands (water / sand / grass / stone / snow) without copying data.
MATERIAL_RGB = jnp.array(
    [
        [0.00, 0.00, 0.00],  # 0 empty
        [0.13, 0.33, 0.80],  # 1 water
        [0.86, 0.79, 0.46],  # 2 sand
        [0.22, 0.63, 0.25],  # 3 grass
        [0.52, 0.50, 0.48],  # 4 stone
        [0.95, 0.95, 0.97],  # 5 snow
        [0.80, 0.25, 0.20],  # 6 accent (lights/markers in test scenes)
        [0.92, 0.75, 0.20],  # 7 accent 2
    ],
    dtype=jnp.float32,
)


@pytree_dataclass
class VoxelGrid:
    """The world. All leaves live on device; shapes are static.

    occupancy: uint8 [X, Y, Z], 0 = empty, >0 = material id.
    rgb:       float32 [X, Y, Z, 3] or None — per-voxel albedo. When None,
               albedo comes from MATERIAL_RGB[occupancy].

    (Soft/differentiable densities live in render.soft.SoftGrid — the hard
    grid carries no density field.)
    """

    occupancy: jax.Array
    rgb: jax.Array | None = None

    @property
    def dims(self) -> tuple[int, int, int]:
        return tuple(self.occupancy.shape)  # type: ignore[return-value]

    def albedo_flat(self) -> jax.Array:
        """[X*Y*Z, 3] float32 albedo table for gather-by-linear-index.

        Only used on small grids (soft-grid init); hot paths use
        ``albedo()``, which gathers one plane per channel.
        """
        if self.rgb is not None:
            return self.rgb.reshape(-1, 3)
        occ = self.occupancy.reshape(-1).astype(jnp.int32)
        return MATERIAL_RGB[jnp.minimum(occ, MATERIAL_RGB.shape[0] - 1)]

    def albedo(self) -> "Albedo":
        """Gather-friendly albedo source for shading (no [N,3] tables)."""
        if self.rgb is not None:
            chans = tuple(self.rgb[..., c].reshape(-1) for c in range(3))
            return Albedo(ids=None, palette=None, channels=chans)
        return Albedo(
            ids=self.occupancy.reshape(-1), palette=MATERIAL_RGB, channels=None
        )


@pytree_dataclass
class Albedo:
    """Per-hit-voxel color source, laid out so gathers stay 1D.

    Two modes (exactly one is set):
      * palette: ``ids`` uint8 [X*Y*Z] material ids + ``palette`` [M,3] —
        one u8 gather per ray, then a tiny table lookup. This is the analog
        of the reference kernel's voxel-id -> color mapping (SURVEY.md §4.3)
        and the only sane mode at 512^3.
      * channels: 3 separate float32 [X*Y*Z] planes (per-voxel RGB) — three
        1D gathers; avoids the [N,3]-table lane padding (see albedo_flat).
    """

    ids: jax.Array | None = None
    palette: jax.Array | None = None
    channels: tuple | None = None

    def at(self, idx: jax.Array) -> jax.Array:
        """Albedo [N,3] at clipped linear voxel indices idx [N]."""
        if self.channels is not None:
            return jnp.stack(
                [jnp.take(c, idx, axis=0) for c in self.channels], axis=-1
            )
        ids = jnp.take(self.ids, idx, axis=0).astype(jnp.int32)
        return jnp.take(
            self.palette, jnp.minimum(ids, self.palette.shape[0] - 1), axis=0
        )

    @property
    def size(self) -> int:
        return self.ids.shape[0] if self.ids is not None else self.channels[0].shape[0]


def linear_index(v: jax.Array, dims: tuple[int, int, int]) -> jax.Array:
    """Row-major linear index of int voxel coords v[..., 3] (no bounds check)."""
    X, Y, Z = dims
    return (v[..., 0] * Y + v[..., 1]) * Z + v[..., 2]


def in_bounds(v: jax.Array, dims: tuple[int, int, int]) -> jax.Array:
    """Bool [...] mask: all three coords inside the grid."""
    lo = jnp.all(v >= 0, axis=-1)
    hi = (v[..., 0] < dims[0]) & (v[..., 1] < dims[1]) & (v[..., 2] < dims[2])
    return lo & hi


def occupancy_at(grid_occ_flat: jax.Array, v: jax.Array, dims: tuple[int, int, int]) -> jax.Array:
    """Gather occupancy at int coords v[..., 3]; out-of-bounds reads return 0.

    grid_occ_flat: uint8 [X*Y*Z] (pre-flattened so callers amortize reshape).
    """
    ok = in_bounds(v, dims)
    idx = jnp.where(ok, linear_index(v, dims), 0)
    val = jnp.take(grid_occ_flat, idx, axis=0)
    return jnp.where(ok, val, jnp.zeros_like(val))

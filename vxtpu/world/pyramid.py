"""Hierarchical empty-space skipping structure: a dense occupancy mipmap.

The reference accelerates its march with a 64-bit-descriptor sparse voxel
octree (SURVEY.md §3 C3, ``Octree::Generate`` / ``GetVoxel``). Pointer-chasing
a descriptor tree does not vectorize over a ray batch, so the *capability*
("hierarchical octree skip", BASELINE.json) is rebuilt as a dense pyramid:
level k is the factor-2^k max-pool of the occupancy — level-k cell (i,j,k)
is nonzero iff ANY fine voxel inside its 2^k-cube is occupied. Lookups are
pure arithmetic (shift the voxel coords), fully vectorizable, and the march
skips a whole coarse cell per step wherever the pyramid says "empty".

Build cost is a few strided max-reductions — the analog of the reference's
recursive CPU octree build, but it runs on-device in microseconds.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vxtpu.utils import pytree_dataclass


@pytree_dataclass
class OccupancyPyramid:
    """levels: tuple of bool arrays; levels[i] has shape ceil(dims / 2^(i+1)).

    levels[0] is the 2x-downsampled occupancy (cell size 2), levels[1] is 4x,
    etc. The fine grid itself is NOT duplicated here. An empty tuple means
    "no acceleration" (plain DDA).
    """

    levels: tuple

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    def cell_size(self, i: int) -> int:
        return 2 ** (i + 1)


def _maxpool2(occ: jax.Array) -> jax.Array:
    """Factor-2 max-pool of a bool/uint8 [X,Y,Z] array (pads odd dims)."""
    X, Y, Z = occ.shape
    px, py, pz = (-X) % 2, (-Y) % 2, (-Z) % 2
    if px or py or pz:
        occ = jnp.pad(occ, ((0, px), (0, py), (0, pz)))
    X2, Y2, Z2 = occ.shape
    r = occ.reshape(X2 // 2, 2, Y2 // 2, 2, Z2 // 2, 2)
    return r.max(axis=(1, 3, 5))


def build_pyramid(occupancy: jax.Array, num_levels: int) -> OccupancyPyramid:
    """Build num_levels coarse levels above the fine occupancy. Jit-safe."""
    levels = []
    cur = (occupancy > 0)
    for _ in range(num_levels):
        cur = _maxpool2(cur)
        levels.append(cur)
    return OccupancyPyramid(levels=tuple(levels))


def pyramid_lookup(pyr: OccupancyPyramid, level: int, v: jax.Array) -> jax.Array:
    """Occupancy of the level-`level` cell containing fine voxel v [...,3].

    Out-of-bounds coords return False (empty), consistent with grid reads.
    level is a Python int (static); v int32.
    """
    arr = pyr.levels[level]
    shift = level + 1
    c = v >> shift
    dims = arr.shape
    ok = (
        (c[..., 0] >= 0) & (c[..., 0] < dims[0])
        & (c[..., 1] >= 0) & (c[..., 1] < dims[1])
        & (c[..., 2] >= 0) & (c[..., 2] < dims[2])
    )
    cc = jnp.clip(c, 0, jnp.asarray(dims, jnp.int32) - 1)
    idx = (cc[..., 0] * dims[1] + cc[..., 1]) * dims[2] + cc[..., 2]
    val = jnp.take(arr.reshape(-1), idx, axis=0)
    return val & ok

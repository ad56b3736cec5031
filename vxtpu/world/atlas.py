"""Texture atlas: per-material face textures sampled at the hit point —
the rebuild of the reference's texture assets (SURVEY.md §3 C17:
voxel face textures sampled in the OpenCL kernel as an image2d).

Layout for gathers: one [M * T * T] flat plane PER CHANNEL (the same
layout rule as world.grid.Albedo). Sampling is nearest-texel: the face axis comes from
the hit normal, the in-face UV from the fractional hit-point coordinates on
the two tangent axes, so textures are world-anchored (no per-face UV
tables) and every ray costs exactly three 1D gathers.

There are no image assets in this repo (and none can be fetched); the atlas
ships a procedural generator producing banded/checker/noise texel patterns
per material, modulating the MATERIAL_RGB palette — the capability (face
texturing in the hot path) is what's normative, not the artwork.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vxtpu.utils import pytree_dataclass
from vxtpu.world.grid import MATERIAL_RGB

_AXIS_TANGENTS = jnp.array(
    [[1, 2], [0, 2], [0, 1]], dtype=jnp.int32
)  # face axis -> (u axis, v axis)


@pytree_dataclass(static=("tex_size",))
class TextureAtlas:
    """channels: three float32 [M * T * T] planes (r, g, b); tex_size = T."""

    channels: tuple
    tex_size: int

    @property
    def num_materials(self) -> int:
        return self.channels[0].shape[0] // (self.tex_size * self.tex_size)


def build_procedural_atlas(num_materials: int | None = None,
                           tex_size: int = 16, seed: int = 0,
                           palette: jax.Array | None = None) -> TextureAtlas:
    """Per-material texel patterns modulating the palette color:
    value-noise brightness + a subtle checker, different per material."""
    palette = MATERIAL_RGB if palette is None else palette
    M = palette.shape[0] if num_materials is None else num_materials
    if M > palette.shape[0]:
        raise ValueError(
            f"build_procedural_atlas: num_materials={M} exceeds the "
            f"palette's {palette.shape[0]} rows; pass a larger palette= "
            "or fewer materials")
    T = tex_size
    key = jax.random.PRNGKey(seed)
    noise = jax.random.uniform(key, (M, T, T), minval=0.75, maxval=1.25)
    iu = jnp.arange(T)
    checker = ((iu[:, None] // 2 + iu[None, :] // 2) % 2).astype(jnp.float32)
    mod = noise * (0.92 + 0.16 * checker)[None, :, :]
    base = palette[:M][:, None, None, :]                     # [M,1,1,3]
    tex = jnp.clip(base * mod[..., None], 0.0, 1.0)          # [M,T,T,3]
    chans = tuple(tex[..., c].reshape(-1) for c in range(3))
    return TextureAtlas(channels=chans, tex_size=T)


def sample_atlas(atlas: TextureAtlas, material_id: jax.Array, p: jax.Array,
                 normal: jax.Array) -> jax.Array:
    """Texel color [N,3] for hits at world points p [N,3] on faces with
    outward normals `normal` [N,3] (axis-aligned one-hot) of voxels with
    material ids `material_id` [N]."""
    T = atlas.tex_size
    ax = jnp.argmax(jnp.abs(normal), axis=-1)                # face axis [N]
    tang = jnp.take(_AXIS_TANGENTS, ax, axis=0)              # [N,2]
    pu = jnp.take_along_axis(p, tang[:, 0:1], axis=-1)[:, 0]
    pv = jnp.take_along_axis(p, tang[:, 1:2], axis=-1)[:, 0]
    # world-anchored UV: fractional position inside the voxel face
    tu = jnp.clip((pu - jnp.floor(pu)) * T, 0.0, T - 1.0).astype(jnp.int32)
    tv = jnp.clip((pv - jnp.floor(pv)) * T, 0.0, T - 1.0).astype(jnp.int32)
    # out-of-range ids map to row 0 (the "empty" material) rather than
    # silently aliasing the last real material
    m = material_id.astype(jnp.int32)
    m = jnp.where((m < 0) | (m >= atlas.num_materials), 0, m)
    idx = (m * T + tu) * T + tv
    return jnp.stack([jnp.take(c, idx, axis=0) for c in atlas.channels],
                     axis=-1)

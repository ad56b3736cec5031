"""The oracle: per-ray ``lax.while_loop`` 3D-DDA march, vmapped over the ray
batch. Runs on the CPU or the GPU. Obviously-correct by construction — one
ray, one loop, the textbook Amanatides-Woo recurrence — and therefore the
parity target every fast path (kernel_triton, kernel_xla) must allclose
against
(BASELINE.json config 1: "CPU jax.lax.while_loop reference").

This is also the stand-in for the reference's ``Software_Caster``
CPU fallback (SURVEY.md §3 C6): same march, slow but trustworthy.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vxtpu.render import dda
from vxtpu.render.types import HitRecord
from vxtpu.world.grid import in_bounds, linear_index

BIG_T = jnp.float32(1e30)


def march_ref(o: jax.Array, d: jax.Array, occ_flat: jax.Array,
              dims: tuple[int, int, int], max_steps: int,
              t_max: jax.Array | None = None) -> HitRecord:
    """March rays o,d [N,3] through occupancy; returns HitRecord [N].

    t_max: optional [N] — treat the ray as ending at this parameter (shadow
    rays toward a light stop at the light). Crossings at t > t_max are
    misses.
    """
    if t_max is None:
        t_max = jnp.full(o.shape[:-1], BIG_T, dtype=o.dtype)

    def one_ray(o1, d1, tmax1):
        t_enter, t_exit, valid = dda.ray_grid_clip(o1, d1, dims)
        v0, t_next0, t_delta, step = dda.dda_init(o1, d1, t_enter, dims)

        # the voxel containing the entry point may itself be solid
        occ0 = jnp.where(
            in_bounds(v0, dims) & valid,
            jnp.take(occ_flat, jnp.clip(linear_index(v0, dims), 0), axis=0),
            jnp.uint8(0),
        )
        first_hit = (occ0 > 0) & (t_enter <= tmax1)
        entry_mask = dda.entry_face_mask(o1, d1, dims)
        n0 = jnp.where(entry_mask, -jnp.sign(d1), 0.0).astype(jnp.float32)

        # state: v, t_next, hit, t_hit, normal, steps, done
        state = (
            v0,
            t_next0,
            first_hit,
            jnp.where(first_hit, t_enter, BIG_T),
            jnp.where(first_hit, n0, jnp.zeros(3, jnp.float32)),
            jnp.int32(0),
            first_hit | ~valid,
        )

        def cond(s):
            return (~s[6]) & (s[5] < max_steps)

        def body(s):
            v, t_next, hit, t_hit, normal, steps, done = s
            v2, t_next2, t_cross, mask = dda.dda_advance(v, t_next, t_delta, step)
            inside = in_bounds(v2, dims)
            past_end = t_cross > jnp.minimum(t_exit, tmax1)
            occ = jnp.where(
                inside,
                jnp.take(occ_flat, jnp.clip(linear_index(v2, dims), 0), axis=0),
                jnp.uint8(0),
            )
            new_hit = inside & (~past_end) & (occ > 0)
            done2 = new_hit | (~inside) | past_end
            return (
                v2,
                t_next2,
                new_hit,
                jnp.where(new_hit, t_cross, t_hit),
                jnp.where(new_hit, dda.face_normal(mask, step), normal),
                steps + 1,
                done2,
            )

        v, t_next, hit, t_hit, normal, steps, done = jax.lax.while_loop(cond, body, state)
        return HitRecord(hit=hit, t=t_hit, voxel=v, normal=normal, steps=steps)

    return jax.vmap(one_ray)(o, d, t_max)


def make_march_ref(occ_flat, dims, settings, pyramid=None):
    """Bind a march closure with the pipeline's (o, d, t_max) signature.
    The oracle never uses the pyramid — it is the un-accelerated ground
    truth that accelerated paths must match."""
    del pyramid
    max_steps = settings.resolve_max_steps(dims)
    return functools.partial(
        march_ref, occ_flat=occ_flat, dims=dims, max_steps=max_steps
    )

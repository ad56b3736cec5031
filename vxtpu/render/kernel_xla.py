"""Batched XLA march: all rays advance in lock-step under masks.

The reference's OpenCL kernel runs one divergent loop per pixel work-item
(SURVEY.md §4.3); here divergence is rebuilt as *masking* over the whole
ray batch: every ray carries a ``done`` flag, a chunked
``while_loop`` keeps iterating until all rays in the batch are done, and
finished rays simply stop changing state. Empty space is skipped with the
occupancy pyramid (world/pyramid.py): a ray whose current coarse cell is
empty jumps straight to that cell's exit boundary instead of fine-stepping
— the capability of the reference's "hierarchical octree skip" with
vectorizable arithmetic instead of pointer chasing.

This path is pure jnp/lax (no Pallas): XLA's gather handles the occupancy
fetches. It is the parity rung between the per-ray oracle and the Triton
march (render/kernel_triton.py), which runs the same distance-field jump
rule per ray and is the default on the GPU.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vxtpu.render import dda
from vxtpu.render.types import HitRecord
from vxtpu.utils import safe_inverse
from vxtpu.world.distfield import DistanceField, distfield_fetch
from vxtpu.world.grid import in_bounds, linear_index
from vxtpu.world.pyramid import OccupancyPyramid, pyramid_lookup

BIG_T = jnp.float32(1e30)


def _occ_fetch(occ_flat, v, dims):
    """uint8 [N] occupancy at int coords v [N,3]; OOB -> 0."""
    ok = in_bounds(v, dims)
    idx = jnp.where(ok, linear_index(v, dims), 0)
    val = jnp.take(occ_flat, idx, axis=0)
    return jnp.where(ok, val, jnp.zeros_like(val))


def _coarse_exit_t(o, d, inv_d, v, level_shift):
    """Ray parameter at which the ray exits the level cell containing fine
    voxel v (cell size 2^level_shift). o,d,inv_d [N,3], v int32 [N,3]."""
    size = jnp.float32(2 ** level_shift)
    c = (v >> level_shift).astype(jnp.float32)
    # exit boundary per axis: (c+1)*size if d >= 0 else c*size
    bound = jnp.where(d >= 0, (c + 1.0) * size, c * size)
    t_ax = (bound - o) * inv_d
    t_ax = jnp.where(jnp.abs(d) < 1e-12, jnp.full_like(t_ax, 3.0e30), t_ax)
    return jnp.min(t_ax, axis=-1)


def march_xla(o: jax.Array, d: jax.Array, occ_flat: jax.Array,
              dims: tuple[int, int, int], max_steps: int,
              pyramid: OccupancyPyramid | None = None,
              step_chunk: int = 32,
              t_max: jax.Array | None = None) -> HitRecord:
    """March rays o,d [N,3]; returns HitRecord [N]. Semantically identical to
    kernel_ref.march_ref (parity-tested), pyramid or not."""
    n = o.shape[0]
    if t_max is None:
        t_max = jnp.full((n,), BIG_T, dtype=o.dtype)
    levels = pyramid.levels if pyramid is not None else ()
    num_levels = len(levels)

    t_enter, t_exit, valid = dda.ray_grid_clip(o, d, dims)
    t_end = jnp.minimum(t_exit, t_max)
    inv_d = safe_inverse(d)

    v0, t_next0, t_delta, step = dda.dda_init(o, d, t_enter, dims)
    occ0 = _occ_fetch(occ_flat, v0, dims)
    first_hit = valid & (occ0 > 0) & (t_enter <= t_max)
    entry_mask = dda.entry_face_mask(o, d, dims)
    n0 = jnp.where(entry_mask, -jnp.sign(d), 0.0).astype(jnp.float32)

    state = dict(
        v=v0,
        t_next=t_next0,
        hit=first_hit,
        t_hit=jnp.where(first_hit, t_enter, BIG_T),
        normal=jnp.where(first_hit[..., None], n0, 0.0),
        steps=jnp.zeros((n,), jnp.int32),
        done=first_hit | ~valid,
    )

    def one_step(s):
        active = ~s["done"]

        # --- fine DDA step (computed for everyone, applied where active)
        v_f, t_next_f, t_cross_f, mask_f = dda.dda_advance(
            s["v"], s["t_next"], t_delta, step
        )

        if num_levels > 0:
            # Empty-space skip: find the COARSEST level whose cell containing
            # the *current* voxel position is empty, and jump to its exit.
            # (Levels are checked fine->coarse so the final value is the
            # coarsest empty one.)
            skip_shift = jnp.zeros((n,), jnp.int32)
            can_skip = jnp.zeros((n,), bool)
            for li in range(num_levels):
                lvl_empty = ~pyramid_lookup(
                    OccupancyPyramid(levels=levels), li, s["v"]
                )
                take = lvl_empty  # empty at this level -> can skip this size
                skip_shift = jnp.where(take, jnp.int32(li + 1), skip_shift)
                can_skip = can_skip | take

            # exit t of the selected coarse cell (use per-ray shift by
            # selecting among the static levels)
            t_skip = t_cross_f
            for li in range(num_levels):
                t_li = _coarse_exit_t(o, d, inv_d, s["v"], li + 1)
                t_skip = jnp.where(skip_shift == (li + 1), t_li, t_skip)

            do_skip = can_skip & active
            # Re-init DDA at the skip exit; mask = exit axis of the coarse cell
            v_s, t_next_s, _, _ = dda.dda_init(o, d, t_skip, dims)
            # Progress guard: if fp rounding left the re-init inside the same
            # voxel, a skip would loop forever — fall back to the fine step.
            stuck = jnp.all(v_s == s["v"], axis=-1)
            do_skip = do_skip & ~stuck
            # face mask for a skip landing: axis achieving the min exit t.
            # Recompute per selected level for correctness of normals.
            mask_s = mask_f
            for li in range(num_levels):
                size = jnp.float32(2 ** (li + 1))
                c = (s["v"] >> (li + 1)).astype(jnp.float32)
                bound = jnp.where(d >= 0, (c + 1.0) * size, c * size)
                t_ax = (bound - o) * inv_d
                t_ax = jnp.where(jnp.abs(d) < 1e-12, jnp.full_like(t_ax, 3.0e30), t_ax)
                m_li = dda.dda_step_mask(t_ax)
                mask_s = jnp.where((skip_shift == (li + 1))[..., None], m_li, mask_s)

            v_new = jnp.where(do_skip[..., None], v_s, v_f)
            t_next_new = jnp.where(do_skip[..., None], t_next_s, t_next_f)
            t_cross = jnp.where(do_skip, t_skip, t_cross_f)
            mask = jnp.where(do_skip[..., None], mask_s, mask_f)
        else:
            v_new, t_next_new, t_cross, mask = v_f, t_next_f, t_cross_f, mask_f

        inside = in_bounds(v_new, dims)
        past_end = t_cross > t_end
        occ = _occ_fetch(occ_flat, v_new, dims)
        new_hit = active & inside & ~past_end & (occ > 0)
        newly_done = new_hit | (active & (~inside | past_end))

        sel = lambda c, a, b: jnp.where(c, a, b)
        upd = active
        return dict(
            v=sel(upd[..., None], v_new, s["v"]),
            t_next=sel(upd[..., None], t_next_new, s["t_next"]),
            hit=s["hit"] | new_hit,
            t_hit=sel(new_hit, t_cross, s["t_hit"]),
            normal=sel(
                new_hit[..., None],
                jnp.where(mask, -step, 0).astype(jnp.float32),
                s["normal"],
            ),
            steps=s["steps"] + upd.astype(jnp.int32),
            done=s["done"] | newly_done,
        )

    num_chunks = -(-max_steps // step_chunk)

    def chunk_body(s):
        def inner(i, s2):
            return one_step(s2)
        s = jax.lax.fori_loop(0, step_chunk, inner, s)
        return s

    def cond(carry):
        s, ci = carry
        return (~jnp.all(s["done"])) & (ci < num_chunks)

    def body(carry):
        s, ci = carry
        return chunk_body(s), ci + 1

    state, _ = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))

    return HitRecord(
        hit=state["hit"],
        t=state["t_hit"],
        voxel=state["v"],
        normal=state["normal"],
        steps=state["steps"],
    )


def march_xla_df(o: jax.Array, d: jax.Array, df_flat: jax.Array,
                 dims: tuple[int, int, int], max_steps: int,
                 step_chunk: int = 32,
                 t_max: jax.Array | None = None) -> HitRecord:
    """Distance-field march: ONE gather per step yields both the hit test
    (field == 0 means solid) and the safe empty-space jump radius
    (world/distfield.py). Hit-equivalent to march_ref / march_xla: jumps
    only ever cross provably-empty voxels, so the visited-surface sequence
    and hit t/normal match the plain DDA to fp tolerance."""
    n = o.shape[0]
    if t_max is None:
        t_max = jnp.full((n,), BIG_T, dtype=o.dtype)
    t_enter, t_exit, valid = dda.ray_grid_clip(o, d, dims)
    t_end = jnp.minimum(t_exit, t_max)
    inv_d = safe_inverse(d)

    v0, t_next0, t_delta, step = dda.dda_init(o, d, t_enter, dims)
    df0 = distfield_fetch(df_flat, v0, dims)
    first_hit = valid & (df0 == 0) & (t_enter <= t_max)
    entry_mask = dda.entry_face_mask(o, d, dims)
    n0 = jnp.where(entry_mask, -jnp.sign(d), 0.0).astype(jnp.float32)

    state = dict(
        v=v0,
        t_next=t_next0,
        dist=df0,
        hit=first_hit,
        t_hit=jnp.where(first_hit, t_enter, BIG_T),
        normal=jnp.where(first_hit[..., None], n0, 0.0),
        steps=jnp.zeros((n,), jnp.int32),
        done=first_hit | ~valid,
    )

    def one_step(s):
        active = ~s["done"]

        # fine DDA step (always computed; used when dist <= 1)
        v_f, t_next_f, t_cross_f, mask_f = dda.dda_advance(
            s["v"], s["t_next"], t_delta, step
        )

        # empty-space jump: everything in the L_inf ball of radius dist-1
        # around v is empty -> jump to the exit of the world-space box
        # [v - (dist-1), v + dist].
        r = (s["dist"].astype(jnp.int32) - 1).astype(jnp.float32)[..., None]
        vf32 = s["v"].astype(jnp.float32)
        bound = jnp.where(d >= 0, vf32 + r + 1.0, vf32 - r)
        t_ax = (bound - o) * inv_d
        t_ax = jnp.where(jnp.abs(d) < 1e-12, jnp.full_like(t_ax, 3.0e30), t_ax)
        t_jump = jnp.min(t_ax, axis=-1)
        mask_j = dda.dda_step_mask(t_ax)
        v_j, t_next_j, _, _ = dda.dda_init(o, d, t_jump, dims)
        # Progress guard: fp rounding could re-init inside the same voxel.
        stuck = jnp.all(v_j == s["v"], axis=-1)
        do_jump = active & (s["dist"] > 1) & ~stuck

        v_new = jnp.where(do_jump[..., None], v_j, v_f)
        t_next_new = jnp.where(do_jump[..., None], t_next_j, t_next_f)
        t_cross = jnp.where(do_jump, t_jump, t_cross_f)
        mask = jnp.where(do_jump[..., None], mask_j, mask_f)

        inside = in_bounds(v_new, dims)
        past_end = t_cross > t_end
        dfv = distfield_fetch(df_flat, v_new, dims)     # the ONE gather
        new_hit = active & inside & ~past_end & (dfv == 0)
        newly_done = new_hit | (active & (~inside | past_end))

        upd = active
        sel = lambda c, a, b: jnp.where(c, a, b)
        return dict(
            v=sel(upd[..., None], v_new, s["v"]),
            t_next=sel(upd[..., None], t_next_new, s["t_next"]),
            dist=sel(upd, dfv, s["dist"]),
            hit=s["hit"] | new_hit,
            t_hit=sel(new_hit, t_cross, s["t_hit"]),
            normal=sel(
                new_hit[..., None],
                jnp.where(mask, -step, 0).astype(jnp.float32),
                s["normal"],
            ),
            steps=s["steps"] + upd.astype(jnp.int32),
            done=s["done"] | newly_done,
        )

    num_chunks = -(-max_steps // step_chunk)

    def cond(carry):
        s, ci = carry
        return (~jnp.all(s["done"])) & (ci < num_chunks)

    def body(carry):
        s, ci = carry
        s = jax.lax.fori_loop(0, step_chunk, lambda i, s2: one_step(s2), s)
        return s, ci + 1

    state, _ = jax.lax.while_loop(cond, body, (state, jnp.int32(0)))

    return HitRecord(
        hit=state["hit"],
        t=state["t_hit"],
        voxel=state["v"],
        normal=state["normal"],
        steps=state["steps"],
    )


def make_march_xla(occ_flat, dims, settings, accel=None):
    """Pipeline march-factory. ``accel`` selects the empty-space skip:
    a DistanceField (fastest; one gather/step), an OccupancyPyramid
    (honoring settings.pyramid_levels), or None (plain fine DDA)."""
    max_steps = settings.resolve_max_steps(dims)
    if isinstance(accel, DistanceField):
        return functools.partial(
            march_xla_df,
            df_flat=accel.field.reshape(-1),
            dims=dims,
            max_steps=max_steps,
            step_chunk=settings.step_chunk,
        )
    pyr = accel if (accel is not None and settings.pyramid_levels > 0) else None
    return functools.partial(
        march_xla,
        occ_flat=occ_flat,
        dims=dims,
        max_steps=max_steps,
        pyramid=pyr,
        step_chunk=settings.step_chunk,
    )

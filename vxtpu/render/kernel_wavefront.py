"""Wavefront march: active-ray compaction between march phases.

The reference's OpenCL kernel retires each pixel's work-item the moment its
ray terminates (SURVEY.md §4.3). The batched XLA march (kernel_xla.py)
instead pays EVERY ray's gather lane on EVERY step until the globally-
slowest ray finishes; when most rays finish early, most of that gather
traffic is dead lanes. This march answers divergence with COMPACTION, not
masking alone (render/kernel_triton.py answers it with a per-ray loop):

  round r:  pos   = cumsum(active) - 1                 (full width, no gather)
            slots = first B_r active rays              (scatter of ray ids)
            march the B_r-slot buffer K_r steps        (gathers at B_r width)
            scatter surviving state back               (B_r width)

Ray state is packed into THREE arrays so each round moves minimal bytes:
pack1 (flags+dist+steps bitfield), pack2 (voxel coords), t_cur (f32). The
DDA t_next invariant is recomputed from the voxel at buffer load — it is a
pure function of (v, o, d), so compaction carries no float history. The
entry-voxel occupancy fetch happens *inside* the buffer (a per-ray "fresh"
bit makes the first buffered step fetch-only), so invalid rays (those that
miss the grid AABB) never touch memory at all.

Semantics are identical to kernel_xla.march_xla_df / kernel_ref (the same
dda.py primitives, the same jump rule, the same progress guards) —
parity-locked in tests/test_wavefront.py including forced multi-round
schedules. Performance: see bench.py (this is the flagship 512³/1080p path).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from vxtpu.render import dda
from vxtpu.render.types import HitRecord
from vxtpu.utils import safe_inverse
from vxtpu.world.distfield import DistanceField, distfield_fetch
from vxtpu.world.grid import in_bounds

BIG_T = jnp.float32(1e30)
BIG = 3.0e30

# pack1 bit layout
_FRESH = 1 << 0
_DONE = 1 << 1
_HIT = 1 << 2
_AX_SHIFT, _AX_MASK = 3, 0x3
_SG_BIT = 1 << 5                      # set -> step sign +1 on hit axis
_DIST_SHIFT, _DIST_MASK = 6, 0xFF
_STEP_SHIFT = 14                      # 17 bits of step count


def _round_up(x: int, m: int = 1024) -> int:
    return -(-x // m) * m


def _default_schedule(n: int, max_steps: int, valid_count: int | None = None):
    """(buffer, inner_steps) rounds. Sized for primary-ray distributions
    (many quick deaths, tiny long tail); correctness never depends on the
    schedule — the trailing while_loop drains whatever is left.

    Round 1 is always the FULL-WIDTH IDENTITY round (B = n): marching every
    ray in place for the first 8 steps avoids a full-width compaction
    (~10 gathers + 3 scatters + cumsum) whose io can exceed the
    table-gather cost of the dead lanes it would remove. Later rounds
    compact to buffers sized from a survivor curve of a 512³/1080p
    primary-ray distribution (v/5.6 alive after 8 steps, v/56 after 24),
    scaled by valid_count when the caller provides it
    (count_valid_rays)."""
    v = n if valid_count is None else max(int(valid_count), 1)
    sched = [(n, min(8, max_steps))]
    if v >= 8192 and max_steps > 8:
        sched.append((min(max(1024, _round_up(v // 5)), n),
                      min(16, max_steps)))
    if v >= 32768 and max_steps > 24:
        sched.append((min(max(1024, _round_up(v // 40)), n),
                      min(40, max_steps)))
    return tuple(sched)


def count_valid_rays(o: jax.Array, d: jax.Array,
                     dims: tuple[int, int, int]) -> int:
    """Host-side AABB-validity count for scene-adaptive scheduling. One tiny
    jitted reduction; call OUTSIDE the frame jit (the count becomes a static
    schedule). Cache per (camera, grid) — animation frames drift slowly."""
    @jax.jit
    def _count(o, d):
        t_enter, t_exit, valid = dda.ray_grid_clip(o, d, dims)
        return jnp.sum(valid.astype(jnp.int32))

    return int(_count(o, d))


def march_wavefront(o: jax.Array, d: jax.Array, df_flat: jax.Array,
                    dims: tuple[int, int, int], max_steps: int,
                    t_max: jax.Array | None = None,
                    schedule: tuple[tuple[int, int], ...] | None = None,
                    drain_buf: int | None = None,
                    drain_steps: int = 24,
                    inner_chunk: int = 4,
                    use_jumps: bool = True,
                    valid_count: int | None = None,
                    stats: bool = False) -> HitRecord:
    """March rays o,d [N,3] against a distance field; HitRecord [N].

    Hit-equivalent to kernel_xla.march_xla_df (parity-tested). ``schedule``
    is a static tuple of (buffer_size, steps) compaction rounds; a safety
    while_loop with (drain_buf, drain_steps) rounds finishes any stragglers,
    so results are schedule-independent. ``valid_count`` sizes the default
    schedule adaptively (see count_valid_rays).

    stats=True additionally returns a dict of execution counters for
    roofline accounting (bench.py): per-round active counts and steps
    actually executed, drain round/step totals — gathered-lane traffic is
    exactly sum(B_r * steps_r) since every slot fetches every step.
    """
    n = o.shape[0]
    X, Y, Z = dims
    assert max(dims) <= 1024, "wavefront pack2 carries 10 bits per axis"
    if schedule is None:
        schedule = _default_schedule(n, max_steps, valid_count)
    if drain_buf is None:
        drain_buf = max(2048, n // 32)
    drain_buf = min(drain_buf, n)
    if t_max is None:
        t_max = jnp.full((n,), BIG_T, dtype=o.dtype)

    # ---- full-width init: pure elementwise, no memory traffic
    t_enter, t_exit, valid = dda.ray_grid_clip(o, d, dims)
    t_end = jnp.minimum(t_exit, t_max)
    valid = valid & (t_enter <= t_end)
    v0, _, _, _ = dda.dda_init(o, d, t_enter, dims)

    pack1 = jnp.where(valid, jnp.int32(_FRESH), jnp.int32(_DONE))
    pack2 = (v0[:, 0] << 20) | (v0[:, 1] << 10) | v0[:, 2]
    t_cur = t_enter

    def unpack_v(p2):
        return jnp.stack([(p2 >> 20) & 0x3FF, (p2 >> 10) & 0x3FF,
                          p2 & 0x3FF], axis=-1)

    def run_round(state, B, K):
        pack1, pack2, t_cur = state
        identity = B >= n
        if identity:
            # ---- identity round: the buffer covers EVERY ray, so the
            # compaction machinery (full-width cumsum, ~10 B-wide state
            # gathers, 3 scatters) degenerates to marching the
            # packed state IN PLACE. This is the default round 0: dead/
            # invalid lanes cost only their table-gather lane, which is
            # cheaper than compacting them out at full width.
            count = jnp.sum(((pack1 & _DONE) == 0).astype(jnp.int32))
            p1, p2, tc, ob, db, teb = pack1, pack2, t_cur, o, d, t_end
        else:
            active = (pack1 & _DONE) == 0
            pos = jnp.cumsum(active.astype(jnp.int32)) - 1
            sel = active & (pos < B)
            count = jnp.minimum(jnp.sum(active.astype(jnp.int32)), B)

            ids = jnp.arange(n, dtype=jnp.int32)
            slot_ray = jnp.zeros((B,), jnp.int32).at[
                jnp.where(sel, pos, B)].set(ids, mode="drop")
            slot_live = jnp.arange(B, dtype=jnp.int32) < count

            # ---- gather per-slot state (the only full-table reads/round)
            p1 = jnp.take(pack1, slot_ray, axis=0)
            p2 = jnp.take(pack2, slot_ray, axis=0)
            tc = jnp.take(t_cur, slot_ray, axis=0)
            ob = jnp.take(o, slot_ray, axis=0)
            db = jnp.take(d, slot_ray, axis=0)
            teb = jnp.take(t_end, slot_ray, axis=0)

            # dead slots: mark done so they never fetch or write
            p1 = jnp.where(slot_live, p1, _DONE)

        # ---- per-slot derived constants (elementwise)
        inv_d = safe_inverse(db)
        t_delta = jnp.abs(inv_d)
        step3 = jnp.where(db >= 0, 1, -1).astype(jnp.int32)
        entry_mask = dda.entry_face_mask(ob, db, dims)

        vb = unpack_v(p2)
        # DDA invariant recomputed from the voxel (pure function of v,o,d)
        def t_next_of(v):
            nb = jnp.where(db >= 0, v.astype(ob.dtype) + 1.0,
                           v.astype(ob.dtype))
            tn = (nb - ob) * inv_d
            return jnp.where(jnp.abs(db) < 1e-12, jnp.full_like(tn, BIG), tn)

        st = dict(p1=p1, v=vb, t_next=t_next_of(vb), t=tc)

        def one_step(s):
            p1, v, t_next, t = s["p1"], s["v"], s["t_next"], s["t"]
            act = (p1 & _DONE) == 0
            fresh = (p1 & _FRESH) != 0
            dist = (p1 >> _DIST_SHIFT) & _DIST_MASK
            steps = p1 >> _STEP_SHIFT

            # fine DDA step
            v_f, t_next_f, t_cross_f, mask_f = dda.dda_advance(
                v, t_next, t_delta, step3)

            # empty-space jump (distfield semantics of march_xla_df)
            r = (dist - 1).astype(ob.dtype)[..., None]
            vf32 = v.astype(ob.dtype)
            bound = jnp.where(db >= 0, vf32 + r + 1.0, vf32 - r)
            t_ax = (bound - ob) * inv_d
            t_ax = jnp.where(jnp.abs(db) < 1e-12,
                             jnp.full_like(t_ax, BIG), t_ax)
            t_jump = jnp.min(t_ax, axis=-1)
            mask_j = dda.dda_step_mask(t_ax)
            v_j, t_next_j, _, _ = dda.dda_init(ob, db, t_jump, dims)
            stuck = jnp.all(v_j == v, axis=-1)
            do_jump = (dist > 1) & ~stuck & ~fresh & use_jumps

            v_new = jnp.where(do_jump[..., None], v_j, v_f)
            t_next_new = jnp.where(do_jump[..., None], t_next_j, t_next_f)
            t_cross = jnp.where(do_jump, t_jump, t_cross_f)
            mask = jnp.where(do_jump[..., None], mask_j, mask_f)

            # fresh rays: fetch-only at the current (entry) voxel
            v_new = jnp.where(fresh[..., None], v, v_new)
            t_next_new = jnp.where(fresh[..., None], t_next, t_next_new)
            t_cross = jnp.where(fresh, t, t_cross)
            mask = jnp.where(fresh[..., None], entry_mask, mask)

            inside = in_bounds(v_new, dims)
            past_end = t_cross > teb
            dfv = distfield_fetch(df_flat, v_new, dims).astype(jnp.int32)
            solid = dfv == 0

            new_hit = act & inside & ~past_end & solid
            steps_new = steps + (act & ~fresh).astype(jnp.int32)
            newly_done = new_hit | (act & (~inside | past_end
                                           | (steps_new >= max_steps)))

            ax = jnp.where(mask[..., 1], 1, jnp.where(mask[..., 2], 2, 0))
            sg = jnp.take_along_axis(step3, ax[..., None], axis=-1)[..., 0]
            # ~fresh jump/step masks always have sign step3[ax]; entry mask
            # normal sign is -sign(d) on the axis = same step3[ax] rule.

            upd = act
            p1_new = (
                jnp.where(new_hit, _HIT, 0)
                | jnp.where(newly_done, _DONE, 0)
                | jnp.where(new_hit, (ax << _AX_SHIFT)
                            | jnp.where(sg > 0, _SG_BIT, 0), 0)
                | (jnp.clip(dfv, 0, 255) << _DIST_SHIFT)
                | (steps_new << _STEP_SHIFT)
            )
            return dict(
                p1=jnp.where(upd, p1_new, p1),
                v=jnp.where(upd[..., None], v_new, v),
                t_next=jnp.where(upd[..., None], t_next_new, t_next),
                t=jnp.where(upd, t_cross, t),
            )

        # chunked early exit: stop once the whole buffer is done
        chunk = inner_chunk
        n_chunks = -(-K // chunk)

        def cond(c):
            s, ci = c
            return (ci < n_chunks) & jnp.any((s["p1"] & _DONE) == 0)

        def body(c):
            s, ci = c
            s = jax.lax.fori_loop(0, chunk, lambda i, s2: one_step(s2), s)
            return s, ci + 1

        st, chunks_exec = jax.lax.while_loop(cond, body, (st, jnp.int32(0)))

        p2_out = (st["v"][:, 0] << 20) | (st["v"][:, 1] << 10) | st["v"][:, 2]
        if identity:
            # in-place round: the buffer IS the full state
            pack1, pack2, t_cur = st["p1"], p2_out, st["t"]
        else:
            # ---- scatter state back (dead slots dropped)
            tgt = jnp.where(slot_live, slot_ray, n)
            pack1 = pack1.at[tgt].set(st["p1"], mode="drop")
            pack2 = pack2.at[tgt].set(p2_out, mode="drop")
            t_cur = t_cur.at[tgt].set(st["t"], mode="drop")
        return (pack1, pack2, t_cur), count, chunks_exec

    state = (pack1, pack2, t_cur)
    round_counts, round_steps = [], []
    for B, K in schedule:
        state, cnt, chx = run_round(state, int(B), int(K))
        round_counts.append(cnt)
        round_steps.append(chx * inner_chunk)

    # safety drain: schedule-independent correctness for any scene
    max_rounds = jnp.int32(
        -(-n // drain_buf) * (-(-max_steps // max(drain_steps, 1)) + 1) + 4
    )

    def drain_cond(c):
        (p1, _, _), r, _ = c
        return (r < max_rounds) & jnp.any((p1 & _DONE) == 0)

    def drain_body(c):
        s, r, dsteps = c
        s, _, chx = run_round(s, drain_buf, drain_steps)
        return s, r + 1, dsteps + chx * inner_chunk

    state, drain_rounds, drain_steps_total = jax.lax.while_loop(
        drain_cond, drain_body, (state, jnp.int32(0), jnp.int32(0)))
    pack1, pack2, t_cur = state

    hit = (pack1 & _HIT) != 0
    ax = (pack1 >> _AX_SHIFT) & _AX_MASK
    sg = jnp.where((pack1 & _SG_BIT) != 0, 1.0, -1.0)
    normal = -sg[:, None] * jax.nn.one_hot(ax, 3, dtype=jnp.float32)
    normal = jnp.where(hit[:, None], normal, 0.0)
    rec = HitRecord(
        hit=hit,
        t=jnp.where(hit, t_cur, BIG_T),
        voxel=unpack_v(pack2),
        normal=normal,
        steps=pack1 >> _STEP_SHIFT,
    )
    if not stats:
        return rec
    # exact execution counters: gathered table lanes = sum(B * steps_exec)
    # (every slot fetches every executed step, dead or not); compaction
    # overhead = per-round full-width cumsum + ~9 B-wide gathers/scatters.
    # float32 accumulation: worst-case lane counts (n * max_steps) overflow
    # int32; f32's 2^24 mantissa is ample for accounting purposes
    sched_lanes = sum(jnp.float32(B) * s.astype(jnp.float32)
                      for (B, _), s in zip(schedule, round_steps))
    st = dict(
        n_rays=n,
        valid=jnp.sum(valid.astype(jnp.int32)),
        schedule=tuple(schedule),
        round_counts=round_counts,
        round_steps=round_steps,
        drain_buf=drain_buf,
        drain_rounds=drain_rounds,
        drain_steps_total=drain_steps_total,
        gathered_lanes=sched_lanes
        + jnp.float32(drain_buf) * drain_steps_total.astype(jnp.float32),
        total_rounds=len(schedule) + drain_rounds,
    )
    return rec, st


def make_march_wavefront(occ_flat, dims, settings, accel=None,
                         schedule=None, valid_count=None):
    """Pipeline march-factory (same shape as make_march_xla). ``accel`` must
    be a DistanceField (built from the grid if omitted). ``valid_count``
    (host int from count_valid_rays) sizes the default schedule to the
    scene instead of a fixed ratio."""
    if not isinstance(accel, DistanceField):
        from vxtpu.world import distfield

        occ = occ_flat.reshape(dims)
        accel = distfield.build(occ, cap=96)
    max_steps = settings.resolve_max_steps(dims)
    return functools.partial(
        march_wavefront,
        df_flat=accel.field.reshape(-1),
        dims=dims,
        max_steps=max_steps,
        schedule=schedule,
        valid_count=valid_count,
    )

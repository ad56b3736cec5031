"""Per-ray distance-field march as a GPU kernel (Pallas, Triton route).

The XLA march (render/kernel_xla.march_xla_df) advances every ray of the
frame in lock-step: each trip of its ``while_loop`` reads and writes the
whole ray state in device memory and runs until the slowest ray is done.
This kernel is the reference's own shape instead (SURVEY.md §4.3: one work
item per pixel): a block of rays loops until its own rays are done, the ray
state stays in registers, and each step reads only the one distance-field
byte it needs (a gather load from the u8 field in device memory).

It reads the same u8 Chebyshev distance field (world/distfield.py) with the
same jump rule as ``march_xla_df``, so hits, voxels and normals match the
plain DDA oracle (render/kernel_ref.py). Vectors are kept as separate x/y/z
planes because Triton blocks are powers of two.

Rays come in power-of-two blocks. When the caller passes the frame's
``image_shape`` the rays are reordered so that each block is one image tile
(``tile`` = rows x cols), which keeps divergence inside a block low; other
ray sets are cut into blocks of ``tile[0] * tile[1]`` consecutive rays.

``interpret=True`` runs the kernel in the Pallas interpreter; only tests
pass it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from vxtpu.render import dda
from vxtpu.render.types import HitRecord
from vxtpu import utils
from vxtpu.utils import round_up
from vxtpu.world import distfield
from vxtpu.world.distfield import DistanceField

BIG_T = 1e30
_FAR = 3.0e30        # t of an axis the ray never crosses (d == 0)
_OUTSIDE = 255       # field value read outside the grid (never a hit)
# the shared DDA constants as Python floats: a kernel captures no arrays
_ENTRY_EPS = float(dda.ENTRY_EPS)
_EPS_DIR = float(utils.EPS_DIR)
_BIG = float(utils.BIG)

# measured on an H100 at c5's frame (PERF.md): tiles of 128 to 256 rays
# with 4 warps are equal within noise; 32x32 tiles are slower
DEFAULT_TILE = (16, 16)
_NUM_WARPS = 4


def _min3(a, b, c):
    return jnp.minimum(jnp.minimum(a, b), c)


def _argmin3(a, b, c):
    """One-hot (x, y, z) of the smallest of three; ties go to the lower axis
    (render/dda.dda_step_mask)."""
    mx = (a <= b) & (a <= c)
    my = ~mx & (b <= c)
    return mx, my, ~mx & ~my


def _argmax3(a, b, c):
    """One-hot of the largest of three, ties to the lower axis
    (render/dda.entry_face_mask)."""
    mx = (a >= b) & (a >= c)
    my = ~mx & (b >= c)
    return mx, my, ~mx & ~my


def _safe_inverse(d):
    """utils.safe_inverse with Python-float constants."""
    sign = jnp.where(d >= 0, 1.0, -1.0)
    return jnp.clip(sign / jnp.maximum(jnp.abs(d), _EPS_DIR), -_BIG, _BIG)


def _axis_init(o, d, inv, t, n):
    """render/dda.dda_init for one axis: voxel coordinate and next boundary
    crossing t of a ray restarted at parameter t."""
    p = o + (t + _ENTRY_EPS) * d
    v = jnp.clip(jnp.floor(p).astype(jnp.int32), 0, n - 1)
    vf = v.astype(jnp.float32)
    t_next = (jnp.where(d >= 0, vf + 1.0, vf) - o) * inv
    return v, jnp.where(jnp.abs(d) < 1e-12, _FAR, t_next)


def _march_kernel(ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref, tmax_ref,
                  df_ref,
                  hit_ref, t_ref, vx_ref, vy_ref, vz_ref, nx_ref, ny_ref,
                  nz_ref, steps_ref, *, dims, max_steps):
    X, Y, Z = dims
    o = (ox_ref[...], oy_ref[...], oz_ref[...])
    d = (dx_ref[...], dy_ref[...], dz_ref[...])
    t_max = tmax_ref[...]
    inv = tuple(_safe_inverse(c) for c in d)
    step = tuple(jnp.where(c >= 0, 1, -1).astype(jnp.int32) for c in d)
    t_delta = tuple(jnp.abs(c) for c in inv)

    def fetch(v, live):
        """Field byte at voxel v; 255 outside the grid or for dead lanes."""
        ok = live
        for c, n in zip(v, dims):
            ok = ok & (c >= 0) & (c < n)
        idx = jnp.where(ok, (v[0] * Y + v[1]) * Z + v[2], 0)
        val = plgpu.load(df_ref.at[idx], mask=ok, other=_OUTSIDE)
        return jnp.where(ok, val.astype(jnp.int32), _OUTSIDE)

    # slab test against the grid box (render/dda.ray_grid_clip)
    t_lo = [jnp.minimum((0.0 - oc) * ic, (n - oc) * ic)
            for oc, ic, n in zip(o, inv, dims)]
    t_hi = [jnp.maximum((0.0 - oc) * ic, (n - oc) * ic)
            for oc, ic, n in zip(o, inv, dims)]
    t_enter = jnp.maximum(jnp.maximum(jnp.maximum(t_lo[0], t_lo[1]),
                                      t_lo[2]), 0.0)
    t_end = jnp.minimum(_min3(*t_hi), t_max)
    valid = t_enter <= _min3(*t_hi)

    v0, tn0 = zip(*(_axis_init(oc, dc, ic, t_enter, n)
                    for oc, dc, ic, n in zip(o, d, inv, dims)))
    dist0 = fetch(v0, valid)
    first_hit = valid & (dist0 == 0) & (t_enter <= t_max)
    entry = _argmax3(*t_lo)
    n0 = tuple(jnp.where(first_hit & e, -jnp.sign(dc), 0.0)
               for e, dc in zip(entry, d))

    def cond(s):
        done, it = s[7], s[8]
        return (jnp.min(done.astype(jnp.int32)) == 0) & (it < max_steps)

    def body(s):
        v, tn, dist, hit, t_hit, nrm, steps, done, it = s
        active = ~done
        # fine DDA step (render/dda.dda_advance)
        m_f = _argmin3(*tn)
        t_cross_f = _min3(*tn)
        v_f = tuple(vc + jnp.where(m, sc, 0) for vc, m, sc in zip(v, m_f, step))
        tn_f = tuple(tc + jnp.where(m, dc, 0.0)
                     for tc, m, dc in zip(tn, m_f, t_delta))
        # empty-space jump: the L_inf ball of radius dist-1 around v is
        # empty, so jump to the exit of the box [v - (dist-1), v + dist]
        r = (dist - 1).astype(jnp.float32)
        t_ax = []
        for vc, oc, dc, ic in zip(v, o, d, inv):
            vf = vc.astype(jnp.float32)
            bound = jnp.where(dc >= 0, vf + r + 1.0, vf - r)
            t_ax.append(jnp.where(jnp.abs(dc) < 1e-12, _FAR,
                                  (bound - oc) * ic))
        t_jump = _min3(*t_ax)
        m_j = _argmin3(*t_ax)
        v_j, tn_j = zip(*(_axis_init(oc, dc, ic, t_jump, n)
                          for oc, dc, ic, n in zip(o, d, inv, dims)))
        # progress guard: rounding can restart inside the same voxel
        stuck = (v_j[0] == v[0]) & (v_j[1] == v[1]) & (v_j[2] == v[2])
        jump = active & (dist > 1) & ~stuck

        v_n = tuple(jnp.where(jump, a, b) for a, b in zip(v_j, v_f))
        tn_n = tuple(jnp.where(jump, a, b) for a, b in zip(tn_j, tn_f))
        t_cross = jnp.where(jump, t_jump, t_cross_f)
        mask = tuple(jnp.where(jump, a, b) for a, b in zip(m_j, m_f))

        inside = active
        for c, n in zip(v_n, dims):
            inside = inside & (c >= 0) & (c < n)
        past_end = t_cross > t_end
        dist_n = fetch(v_n, inside & ~past_end)
        new_hit = inside & ~past_end & (dist_n == 0)
        newly_done = new_hit | (active & (~inside | past_end))
        return (
            tuple(jnp.where(active, a, b) for a, b in zip(v_n, v)),
            tuple(jnp.where(active, a, b) for a, b in zip(tn_n, tn)),
            jnp.where(active, dist_n, dist),
            hit | new_hit,
            jnp.where(new_hit, t_cross, t_hit),
            tuple(jnp.where(new_hit,
                            jnp.where(m, -sc, 0).astype(jnp.float32), nc)
                  for m, sc, nc in zip(mask, step, nrm)),
            steps + active.astype(jnp.int32),
            done | newly_done,
            it + 1,
        )

    init = (v0, tn0, dist0, first_hit,
            jnp.where(first_hit, t_enter, BIG_T), n0,
            jnp.zeros_like(dist0), first_hit | ~valid, jnp.int32(0))
    v, _, _, hit, t_hit, nrm, steps, _, _ = jax.lax.while_loop(cond, body,
                                                               init)
    hit_ref[...] = hit.astype(jnp.int32)
    t_ref[...] = t_hit
    vx_ref[...], vy_ref[...], vz_ref[...] = v
    nx_ref[...], ny_ref[...], nz_ref[...] = nrm
    steps_ref[...] = steps


def _to_tiles(x, image_shape, tile):
    """[H*W, ...] in scanline order -> [Hp*Wp, ...] in tile order (image
    padded by edge replication to whole tiles)."""
    (h, w), (th, tw) = image_shape, tile
    hp, wp = round_up(h, th), round_up(w, tw)
    rest = x.shape[1:]
    x = x.reshape(h, w, *rest)
    x = jnp.pad(x, ((0, hp - h), (0, wp - w)) + ((0, 0),) * len(rest),
                mode="edge")
    x = x.reshape(hp // th, th, wp // tw, tw, *rest).swapaxes(1, 2)
    return x.reshape(hp * wp, *rest)


def _from_tiles(x, image_shape, tile):
    """Inverse of _to_tiles: tile order -> scanline order, padding dropped."""
    (h, w), (th, tw) = image_shape, tile
    hp, wp = round_up(h, th), round_up(w, tw)
    rest = x.shape[1:]
    x = x.reshape(hp // th, wp // tw, th, tw, *rest).swapaxes(1, 2)
    return x.reshape(hp, wp, *rest)[:h, :w].reshape(h * w, *rest)


def march_triton(o: jax.Array, d: jax.Array, df_flat: jax.Array,
                 dims: tuple[int, int, int], max_steps: int,
                 t_max: jax.Array | None = None, *,
                 image_shape: tuple[int, int] | None = None,
                 tile: tuple[int, int] = DEFAULT_TILE,
                 interpret: bool = False) -> HitRecord:
    """March rays o, d [N,3] through the u8 distance field df_flat
    [X*Y*Z]; returns HitRecord [N]. Hit-equivalent to kernel_ref.march_ref.

    image_shape: (H, W) of the frame the rays come from (H*W == N); blocks
    are then image tiles of ``tile`` rows x cols. Otherwise blocks are
    tile[0]*tile[1] consecutive rays.
    """
    n = o.shape[0]
    block = tile[0] * tile[1]
    if block & (block - 1):
        raise ValueError(f"tile {tile} is not a power-of-two block")
    if t_max is None:
        t_max = jnp.full((n,), BIG_T, jnp.float32)
    rays = jnp.concatenate([o, d, t_max[:, None]], axis=1)     # [N, 7]
    tiled = image_shape is not None and image_shape[0] * image_shape[1] == n
    if tiled:
        rays = _to_tiles(rays, image_shape, tile)
    n_pad = round_up(rays.shape[0], block)
    # padding rays start outside the grid and point away from it: they
    # are done before the first step
    pad = jnp.tile(jnp.asarray([[-1.0, -1.0, -1.0, 0.0, 0.0, -1.0, 0.0]],
                               jnp.float32), (n_pad - rays.shape[0], 1))
    planes = jnp.concatenate([rays, pad], axis=0).T               # [7, Np]

    spec = pl.BlockSpec((block,), lambda i: (i,))
    out_dtypes = ((jnp.int32,) + (jnp.float32,) + (jnp.int32,) * 3
                  + (jnp.float32,) * 3 + (jnp.int32,))
    outs = pl.pallas_call(
        functools.partial(_march_kernel, dims=tuple(dims),
                          max_steps=max_steps),
        out_shape=[jax.ShapeDtypeStruct((n_pad,), dt) for dt in out_dtypes],
        grid=(n_pad // block,),
        in_specs=[spec] * 7 + [pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=[spec] * len(out_dtypes),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="vx_march_triton",
    )(*planes, df_flat)
    hit, t, vx, vy, vz, nx, ny, nz, steps = outs
    rec = HitRecord(hit=hit != 0, t=t, voxel=jnp.stack([vx, vy, vz], -1),
                    normal=jnp.stack([nx, ny, nz], -1), steps=steps)
    if tiled:
        return jax.tree_util.tree_map(
            lambda x: _from_tiles(x, image_shape, tile), rec)
    return jax.tree_util.tree_map(lambda x: x[:n], rec)


def make_march_triton(occ_flat, dims, settings, accel=None, *,
                      image_shape=None, tile=DEFAULT_TILE, interpret=False):
    """Pipeline march-factory. ``accel`` is the scene's DistanceField; with
    None one is built from the occupancy."""
    if accel is None:
        accel = distfield.build(occ_flat.reshape(dims))
    if not isinstance(accel, DistanceField):
        raise TypeError("the triton march reads a DistanceField accel, got "
                        f"{type(accel).__name__}")
    return functools.partial(
        march_triton, df_flat=accel.field.reshape(-1), dims=tuple(dims),
        max_steps=settings.resolve_max_steps(dims), image_shape=image_shape,
        tile=tile, interpret=interpret)

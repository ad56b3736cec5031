"""The per-ray Triton march (render/kernel_triton.py) in Pallas interpret
mode on the CPU: parity with the per-ray oracle (render/kernel_ref.py), bit
equality with the XLA distance-field march it shares its jump rule with, the
wrapper's padding and image tiling, and the edge cases of the loop."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vxtpu.camera.camera import Camera
from vxtpu.camera.rays import generate_rays
from vxtpu.render.kernel_ref import make_march_ref
from vxtpu.render.kernel_triton import (_from_tiles, _to_tiles,
                                        make_march_triton)
from vxtpu.render.kernel_xla import make_march_xla
from vxtpu.render.settings import RenderSettings
from vxtpu.world import distfield, procgen
from vxtpu.world.pyramid import build_pyramid

DIMS = (32, 32, 32)
H = W = 24


def _scene(name):
    if name == "box":
        return procgen.solid_box(DIMS, (8, 8, 8), (24, 24, 20))
    if name == "sphere":
        return procgen.shell_sphere(DIMS)
    return procgen.terrain(DIMS, seed=11)


_CAMERAS = {
    "outside": Camera.make(pos=(-20.0, 16.0, 40.0)).look_at((16.0, 16.0, 12.0)),
    "inside": Camera.make(pos=(16.0, 16.0, 28.0), yaw=2.2, pitch=-0.5),
}


def _triton(grid, settings=RenderSettings(), **kw):
    occ = grid.occupancy.reshape(-1)
    return jax.jit(make_march_triton(occ, grid.dims, settings,
                                     interpret=True, **kw))


def _assert_matches_oracle(r, f):
    hit_r, hit_f = np.asarray(r.hit), np.asarray(f.hit)
    assert (hit_r == hit_f).mean() > 0.998
    both = hit_r & hit_f
    if not both.any():
        return
    np.testing.assert_allclose(np.asarray(f.t)[both], np.asarray(r.t)[both],
                               rtol=1e-4, atol=1e-3)
    assert (np.asarray(f.voxel)[both]
            == np.asarray(r.voxel)[both]).all(-1).mean() > 0.998
    assert (np.abs(np.asarray(f.normal)[both] - np.asarray(r.normal)[both])
            < 1e-6).all(-1).mean() > 0.995


def _assert_equal(a, b):
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("scene", ["box", "sphere", "terrain"])
@pytest.mark.parametrize("cam", ["outside", "inside"])
@pytest.mark.parametrize("bounded", [False, True])
def test_matches_oracle(scene, cam, bounded):
    """Primary rays, and with ``bounded`` rays that end at a per-ray t_max
    (the shadow-ray contract of render/pipeline.shadow_visibility)."""
    grid = _scene(scene)
    o, d = generate_rays(_CAMERAS[cam], H, W)
    t_max = (jnp.linspace(10.0, 70.0, H * W) if bounded else None)
    ref = make_march_ref(grid.occupancy.reshape(-1), DIMS, RenderSettings())
    r = jax.jit(ref)(o, d, t_max=t_max)
    f = _triton(grid, image_shape=(H, W))(o, d, t_max=t_max)
    _assert_matches_oracle(r, f)
    if bounded:
        assert (np.asarray(f.t)[np.asarray(f.hit)]
                <= np.asarray(t_max)[np.asarray(f.hit)]).all()


@pytest.mark.parametrize("scene", ["box", "sphere", "terrain"])
def test_bit_equal_to_xla_distance_field_march(scene):
    """Same field, same jump rule: every output of the per-ray kernel equals
    the lock-step XLA march's, step counts included."""
    grid = _scene(scene)
    accel = distfield.build(grid.occupancy)
    occ = grid.occupancy.reshape(-1)
    o, d = generate_rays(_CAMERAS["outside"], H, W)
    x = jax.jit(make_march_xla(occ, DIMS, RenderSettings(), accel))(o, d)
    f = _triton(grid, accel=accel)(o, d)
    _assert_equal(x, f)


@pytest.mark.parametrize("n", [1, 37, 100, 255, 256, 257])
def test_ray_counts_not_a_multiple_of_the_block(n):
    """Padding rays are dropped; the first n results do not depend on how
    many rays are padded in."""
    grid = _scene("terrain")
    o, d = generate_rays(_CAMERAS["outside"], 20, 20)
    o, d = o[:n], d[:n]
    occ = grid.occupancy.reshape(-1)
    ref = jax.jit(make_march_xla(occ, DIMS, RenderSettings(),
                                 distfield.build(grid.occupancy)))(o, d)
    f = _triton(grid, tile=(8, 16))(o, d)
    assert f.hit.shape == (n,) and f.voxel.shape == (n, 3)
    _assert_equal(ref, f)


@pytest.mark.parametrize("tile", [(1, 32), (2, 16), (4, 8), (8, 16),
                                  (16, 16), (4, 4)])
def test_block_size_does_not_change_results(tile):
    grid = _scene("sphere")
    o, d = generate_rays(_CAMERAS["outside"], H, W)
    base = _triton(grid, image_shape=(H, W), tile=(8, 8))(o, d)
    f = _triton(grid, image_shape=(H, W), tile=tile)(o, d)
    _assert_equal(base, f)
    flat = _triton(grid, tile=tile)(o, d)            # consecutive-ray blocks
    _assert_equal(base, flat)


def test_block_must_be_a_power_of_two():
    grid = _scene("box")
    o, d = generate_rays(_CAMERAS["outside"], 4, 4)
    with pytest.raises(ValueError, match="power-of-two"):
        _triton(grid, tile=(3, 8))(o, d)


@pytest.mark.parametrize("shape,tile", [((5, 7), (4, 4)), ((16, 16), (8, 8)),
                                        ((9, 13), (2, 16)), ((1, 1), (4, 8)),
                                        ((24, 40), (16, 16))])
def test_tile_order_round_trip(shape, tile):
    """Scanline -> tile order -> scanline is the identity, for images that
    are not whole tiles too (edge padding is dropped)."""
    h, w = shape
    x = jnp.arange(h * w * 2, dtype=jnp.float32).reshape(h * w, 2)
    t = _to_tiles(x, shape, tile)
    assert t.shape[0] % (tile[0] * tile[1]) == 0
    np.testing.assert_array_equal(np.asarray(_from_tiles(t, shape, tile)),
                                  np.asarray(x))


def test_tiles_are_contiguous_image_blocks():
    x = jnp.arange(8 * 8)[:, None]
    t = np.asarray(_to_tiles(x, (8, 8), (2, 4)))[:8, 0]
    np.testing.assert_array_equal(t, [0, 1, 2, 3, 8, 9, 10, 11])


@pytest.mark.parametrize("max_steps", [1, 4, 16])
def test_step_budget_exhaustion(max_steps):
    """With a small budget the loop stops after max_steps; every hit it did
    find is the oracle's hit."""
    grid = _scene("terrain")
    o, d = generate_rays(_CAMERAS["outside"], H, W)
    occ = grid.occupancy.reshape(-1)
    r = jax.jit(make_march_ref(occ, DIMS, RenderSettings()))(o, d)
    f = _triton(grid, RenderSettings(max_steps=max_steps))(o, d)
    assert int(jnp.max(f.steps)) <= max_steps
    found = np.asarray(f.hit)
    assert not (found & ~np.asarray(r.hit)).any()
    np.testing.assert_allclose(np.asarray(f.t)[found], np.asarray(r.t)[found],
                               rtol=1e-4, atol=1e-3)


def test_rays_that_miss_the_grid():
    grid = _scene("box")
    cam = Camera.make(pos=(-20.0, 16.0, 16.0)).look_at((-40.0, 16.0, 16.0))
    o, d = generate_rays(cam, 8, 8)
    f = _triton(grid)(o, d)
    assert not np.asarray(f.hit).any()
    assert (np.asarray(f.steps) == 0).all()


def test_rays_that_start_inside_solid():
    """A camera inside a solid block hits at t = 0 (the oracle's first-voxel
    rule)."""
    grid = procgen.solid_box(DIMS, (0, 0, 0), (32, 32, 32))
    cam = Camera.make(pos=(16.0, 16.0, 16.0), yaw=0.4, pitch=0.2)
    o, d = generate_rays(cam, 8, 8)
    r = jax.jit(make_march_ref(grid.occupancy.reshape(-1), DIMS,
                               RenderSettings()))(o, d)
    f = _triton(grid)(o, d)
    assert np.asarray(f.hit).all()
    np.testing.assert_array_equal(np.asarray(f.t), 0.0)
    _assert_matches_oracle(r, f)


def test_axis_aligned_rays():
    """Direction components of exactly zero never cross their planes."""
    grid = procgen.solid_box(DIMS, (20, 0, 0), (22, 32, 32))
    o = jnp.asarray([[0.5, 16.0, 16.0], [0.5, 3.5, 7.5], [31.5, 16.0, 16.0],
                     [16.5, 16.5, 40.0]])
    d = jnp.asarray([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [-1.0, 0.0, 0.0],
                     [0.0, 0.0, -1.0]])
    r = jax.jit(make_march_ref(grid.occupancy.reshape(-1), DIMS,
                               RenderSettings()))(o, d)
    f = _triton(grid)(o, d)
    _assert_equal(r.hit, f.hit)
    _assert_matches_oracle(r, f)


def test_shadow_ray_stops_at_t_max():
    grid = procgen.solid_box(DIMS, (20, 0, 0), (22, 32, 32))
    o = jnp.asarray([[0.5, 16.0, 16.0]] * 2)
    d = jnp.asarray([[1.0, 0.0, 0.0]] * 2)
    f = _triton(grid)(o, d, t_max=jnp.asarray([10.0, 30.0]))
    assert not bool(f.hit[0]) and bool(f.hit[1])


def test_factory_builds_the_field_or_takes_the_scenes():
    grid = _scene("terrain")
    o, d = generate_rays(_CAMERAS["outside"], 8, 8)
    built = _triton(grid)(o, d)
    given = _triton(grid, accel=distfield.build(grid.occupancy, cap=24))(o, d)
    _assert_equal(built, given)


def test_factory_rejects_other_accels():
    grid = _scene("box")
    with pytest.raises(TypeError, match="DistanceField"):
        make_march_triton(grid.occupancy.reshape(-1), DIMS, RenderSettings(),
                          build_pyramid(grid.occupancy, 2))


def test_lowers_for_the_gpu():
    """The kernel lowers to Triton IR from this machine; the card compiles
    it (tests/test_device.py)."""
    grid = _scene("terrain")
    o, d = generate_rays(_CAMERAS["outside"], 8, 8)
    fn = jax.jit(make_march_triton(grid.occupancy.reshape(-1), DIMS,
                                   RenderSettings()))
    text = fn.trace(o, d).lower(lowering_platforms=("cuda",)).as_text()
    assert "vx_march_triton" in text

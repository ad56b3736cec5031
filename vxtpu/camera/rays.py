"""Per-pixel ray generation.

The reference precomputes a per-pixel "viewport matrix" of ray directions on
the host, re-uploading on resize, and rotates it by the camera angles in the
kernel (SURVEY.md §3 C8). Here the whole computation is a handful of fused
elementwise ops per pixel, so we just generate rays inside the jitted step — no
caching, no host->device churn, and the rays stay differentiable w.r.t. the
camera pose.

Pixel convention: pixel (row=i, col=j) of an H x W image, i down, j right;
the ray passes through the pixel *center*. Row 0 is the TOP of the image
(up in the world), matching PNG layout.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from vxtpu.camera.camera import Camera


def generate_rays(cam: Camera, height: int, width: int):
    """Returns (origins [H*W, 3], dirs [H*W, 3]) — unit-norm directions,
    row-major flattened so ``dirs.reshape(H, W, 3)`` is the image layout.
    """
    forward, right, up = cam.basis()
    # NDC in [-1, 1] at pixel centers; y flipped so row 0 maps to +up.
    i = (jnp.arange(height, dtype=jnp.float32) + 0.5) / height * 2.0 - 1.0
    j = (jnp.arange(width, dtype=jnp.float32) + 0.5) / width * 2.0 - 1.0
    tan_half = jnp.tan(cam.fov_y * 0.5)
    aspect = width / height
    yy = -i * tan_half               # [H]
    xx = j * tan_half * aspect       # [W]
    d = (
        forward[None, None, :]
        + xx[None, :, None] * right[None, None, :]
        + yy[:, None, None] * up[None, None, :]
    )  # [H, W, 3]
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    o = jnp.broadcast_to(cam.pos, (height, width, 3))
    return o.reshape(-1, 3), d.reshape(-1, 3)

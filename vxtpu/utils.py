"""Small shared helpers (pytree dataclasses, safe math, image IO).

Reference analog: ``util.hpp`` / ``Vector4.h`` (SURVEY.md section 3, C16) —
timers, math helpers. Here the math helpers are the numerically-careful
primitives every kernel shares (safe reciprocal of ray directions, AABB
slab tests live in render/dda.py), so that the oracle, the XLA fast path
and the Pallas kernel compute bit-identical quantities.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Any, Callable, TypeVar

import jax
import jax.numpy as jnp
import numpy as np

_T = TypeVar("_T")

# Large-but-finite stand-in for 1/0 in ray-direction reciprocals. Finite so
# that downstream arithmetic (t_max = (boundary - o) * inv) never produces
# inf - inf = nan for axis-aligned rays.
BIG = jnp.float32(1e30)
# Smallest |d| component treated as nonzero.
EPS_DIR = jnp.float32(1e-12)


def pytree_dataclass(cls: type | None = None, *, static: tuple[str, ...] = ()):
    """Register a frozen dataclass as a JAX pytree.

    Fields named in ``static`` become aux (hashable, trigger recompiles);
    all other fields are traced children.
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        all_fields = [f.name for f in dataclasses.fields(c)]
        data_fields = [n for n in all_fields if n not in static]
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=list(static)
        )

        def _replace(self, **kw):
            return dataclasses.replace(self, **kw)

        c.replace = _replace
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def safe_inverse(d: jax.Array) -> jax.Array:
    """1/d with zero components mapped to a signed big-but-finite value.

    The classic DDA trick: an axis-aligned ray never crosses the degenerate
    axis's planes, so its per-axis crossing t just needs to be "very large".
    Keeping it finite avoids inf*0 = nan in the slab test.
    """
    sign = jnp.where(d >= 0, 1.0, -1.0).astype(d.dtype)
    mag = jnp.maximum(jnp.abs(d), EPS_DIR)
    inv = sign / mag
    return jnp.clip(inv, -BIG, BIG)


def normalize(v: jax.Array, axis: int = -1, eps: float = 1e-20) -> jax.Array:
    return v * jax.lax.rsqrt(jnp.sum(v * v, axis=axis, keepdims=True) + eps)


def to_uint8_image(img: jax.Array | np.ndarray) -> np.ndarray:
    """[H, W, 3] float in [0, 1] -> uint8, gamma-less (matches reference's
    direct write_imagef [K, SURVEY section 4.3])."""
    arr = np.asarray(jax.device_get(img))
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG file bytes (8-bit RGB, no filtering), with
    nothing but the standard library."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected an [H, W, 3] image, got {rgb.shape}")
    h, w, _ = rgb.shape
    # each scanline is prefixed with filter type 0 (none)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)],
                         axis=1).tobytes()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def save_png(path: str, img: jax.Array | np.ndarray) -> None:
    """Write an [H, W, 3] float image in [0, 1] as an RGB PNG."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(to_uint8_image(img)))


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def tree_bytes(tree: Any) -> int:
    """Total bytes of all array leaves (memory-fit checks, engine/platform)."""
    leaves = jax.tree_util.tree_leaves(tree)
    return sum(l.size * l.dtype.itemsize for l in leaves if hasattr(l, "dtype"))

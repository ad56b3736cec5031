"""Losses/metrics for the inverse-rendering loop (BASELINE.json config 4:
"optimize voxel colors/densities from target images"). No reference analog —
the reference renderer has no training capability (SURVEY.md §1)."""

from __future__ import annotations

import jax.numpy as jnp


def mse(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean((pred - target) ** 2)


def psnr(pred: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return -10.0 * jnp.log10(jnp.maximum(mse(pred, target), 1e-12))


def tv_loss(vol: jnp.ndarray) -> jnp.ndarray:
    """Total-variation regularizer over a [X,Y,Z] or channel-major
    [C,X,Y,Z] volume (spatial axes are always the LAST three) — the
    standard Plenoxels-style smoothness prior on voxel grids."""
    dx = jnp.diff(vol, axis=-3)
    dy = jnp.diff(vol, axis=-2)
    dz = jnp.diff(vol, axis=-1)
    return (jnp.mean(dx ** 2) + jnp.mean(dy ** 2) + jnp.mean(dz ** 2)) / 3.0


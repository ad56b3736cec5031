"""Scripted camera paths: pure functions t -> Camera.

The reference's camera moves via input events + impulse/friction physics
(SURVEY.md §3 C7: ``add_relative_impulse``, ``movement *= friction``).
Headless rendering replaces interactivity with deterministic paths —
including an impulse/friction *simulation* so the reference's motion feel
is reproducible as a capability, driven by a scripted impulse schedule
instead of a keyboard.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from vxtpu.camera.camera import Camera


def orbit(center, radius: float, height: float, period: float = 8.0,
          fov_y_deg: float = 60.0) -> Callable[[jax.Array], Camera]:
    """Circular orbit around center, always looking at it."""
    center = jnp.asarray(center, jnp.float32)

    def at(t):
        ang = 2.0 * jnp.pi * t / period
        pos = center + jnp.stack(
            [radius * jnp.cos(ang), radius * jnp.sin(ang), jnp.asarray(height, jnp.float32)]
        )
        return Camera.make(pos, fov_y_deg=fov_y_deg).replace(
            pos=pos.astype(jnp.float32)
        ).look_at(center)

    return at


def orbit_views(center, radius: float, height: float, n: int,
                fov_y_deg: float = 60.0) -> list[Camera]:
    """n cameras evenly spaced on an orbit, all aimed at center — the
    standard multi-view capture rig for inverse rendering (BASELINE config
    4 'target images'; train/loop.py:fit_soft_views)."""
    at = orbit(center, radius, height, period=float(n), fov_y_deg=fov_y_deg)
    return [at(jnp.float32(i)) for i in range(n)]


def flythrough(waypoints: Sequence, look_at, period: float = 10.0,
               fov_y_deg: float = 60.0) -> Callable[[jax.Array], Camera]:
    """Piecewise-linear loop through waypoints, aimed at a fixed target."""
    wp = jnp.asarray(waypoints, jnp.float32)          # [K,3]
    tgt = jnp.asarray(look_at, jnp.float32)
    k = wp.shape[0]

    def at(t):
        u = (t / period) % 1.0 * k
        i0 = jnp.floor(u).astype(jnp.int32) % k
        i1 = (i0 + 1) % k
        f = u - jnp.floor(u)
        pos = wp[i0] * (1.0 - f) + wp[i1] * f
        return Camera.make((0, 0, 0), fov_y_deg=fov_y_deg).replace(pos=pos).look_at(tgt)

    return at


@dataclasses.dataclass(frozen=True)
class ImpulseEvent:
    """A scripted 'key press': relative impulse (camera frame) at time t."""

    t: float
    impulse: tuple[float, float, float]   # (forward, right, up) strength


def physics_path(start: Camera, events: Sequence[ImpulseEvent],
                 friction: float = 0.92, dt: float = 1.0 / 60.0,
                 yaw_rate: float = 0.0, pitch_rate: float = 0.0):
    """Impulse/friction camera physics as a scan — the reference's Camera
    movement model (velocity += impulse; velocity *= friction; pos +=
    velocity·dt) driven by a schedule instead of key events.

    Returns a function steps(n) -> Camera pytree with leading axis n (pose
    per frame), computed in one jitted scan.
    """
    ev_t = jnp.asarray([e.t for e in events], jnp.float32) if events else jnp.zeros((0,))
    ev_i = (
        jnp.asarray([e.impulse for e in events], jnp.float32)
        if events
        else jnp.zeros((0, 3))
    )

    def steps(n: int):
        def body(carry, i):
            pos, vel, yaw, pitch = carry
            t = i.astype(jnp.float32) * dt
            # impulses firing in [t, t+dt)
            fire = (ev_t >= t) & (ev_t < t + dt)
            cam = Camera(pos=pos, yaw=yaw, pitch=pitch, fov_y=start.fov_y)
            f, r, u = cam.basis()
            imp = jnp.sum(
                jnp.where(
                    fire[:, None],
                    ev_i[:, 0:1] * f + ev_i[:, 1:2] * r + ev_i[:, 2:3] * u,
                    0.0,
                ),
                axis=0,
            ) if ev_t.shape[0] else jnp.zeros(3)
            vel = (vel + imp) * friction
            pos = pos + vel * dt
            yaw = yaw + yaw_rate * dt
            pitch = pitch + pitch_rate * dt
            return (pos, vel, yaw, pitch), Camera(
                pos=pos, yaw=yaw, pitch=pitch, fov_y=start.fov_y
            )

        init = (start.pos, jnp.zeros(3), start.yaw, start.pitch)
        _, cams = jax.lax.scan(body, init, jnp.arange(n))
        return cams

    return steps

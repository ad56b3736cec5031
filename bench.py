"""Benchmark on one NVIDIA GPU: prints JSON lines, the headline last.

Headline (BASELINE.json): Mrays/s at 512³ grid, 1080p forward render — the
c5 frame (per-voxel RGB, full shading, shadows, fog) through the per-ray
Triton march. vs_baseline is measured against the 124 Mrays/s target
(1920x1080 at 60 fps). Also timed: the same frame through the lock-step XLA
march, and the c4 train step (512³ soft grid, 256x256 rays, S=256, custom
VJP). Every timing is the median of warm runs that end in
block_until_ready; compile time is reported apart.

    python bench.py

Exits 2 without a GPU: a CPU number is not a device number.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

TARGET_MRAYS = 124.0
ITERS = 5


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def bench_frames(device: dict) -> dict:
    from vxtpu.app.configs import CONFIGS
    from vxtpu.app.run import build_frame, time_frames

    cfg = CONFIGS["c5_1080p_pod"]
    out = {}
    for kernel in ("triton", "xla"):
        frame, fargs = build_frame(cfg, kernel)
        compile_s, times = time_frames(frame, fargs, ITERS)
        dt = statistics.median(times)
        out[kernel] = dt
        print(json.dumps(dict(
            metric="frame", config=cfg.name, kernel=kernel,
            frame_ms=dt * 1e3, mrays=cfg.height * cfg.width / dt / 1e6,
            compile_s=compile_s, **device)), flush=True)
    return out


def bench_train_step(device: dict) -> float:
    import jax

    from vxtpu.app.configs import CONFIGS
    from vxtpu.camera.camera import Camera
    from vxtpu.camera.rays import generate_rays
    from vxtpu.render.soft import SoftGrid, render_soft_image
    from vxtpu.train.loop import TrainConfig, make_optimizer, make_train_step
    from vxtpu.world import procgen

    cfg = CONFIGS["c4_512_diff"]
    X, Y, Z = cfg.dims
    h = w = cfg.height
    cam = Camera.make(pos=(-0.7 * X, 0.5 * Y, 1.1 * Z)).look_at(
        (0.5 * X, 0.5 * Y, 0.27 * Z))
    truth = SoftGrid.from_hard(procgen.terrain(cfg.dims, seed=cfg.seed,
                                               with_rgb=True))
    target = jax.jit(lambda s: render_soft_image(
        s, cam, cfg.settings, h, w, cfg.num_samples))(truth).reshape(-1, 3)
    del truth
    o, d = generate_rays(cam, h, w)
    tc = TrainConfig(num_samples=cfg.num_samples, use_custom_vjp=True)
    params = SoftGrid.zeros(cfg.dims)
    opt_state = make_optimizer(tc).init(params)
    step = make_train_step(cam, (h, w), cfg.settings, tc)
    t0 = time.perf_counter()
    compiled = step.lower(params, opt_state, o, d, target).compile()
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(ITERS + 1):                 # the first run warms up
        t0 = time.perf_counter()
        params, opt_state, loss = compiled(params, opt_state, o, d, target)
        jax.block_until_ready(loss)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times[1:])
    print(json.dumps(dict(
        metric="train_step", config=cfg.name, rays=h * w,
        samples=cfg.num_samples, step_ms=dt * 1e3,
        msamples_per_s=h * w * cfg.num_samples / dt / 1e6,
        compile_s=compile_s, loss=float(loss), **device)), flush=True)
    return dt


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform} devices", file=sys.stderr)
        return 2
    from vxtpu.engine.platform import enable_compilation_cache

    enable_compilation_cache()
    device = dict(platform=dev.platform, device_kind=dev.device_kind,
                  card=_card())
    frames = bench_frames(device)
    step_s = bench_train_step(device)
    mrays = 1920 * 1080 / frames["triton"] / 1e6
    print(json.dumps(dict(
        metric="Mrays/s @ 512^3 grid, 1080p forward", value=mrays,
        unit="Mrays/s", vs_baseline=mrays / TARGET_MRAYS, kernel="triton",
        fps=1.0 / frames["triton"],
        xla_mrays=1920 * 1080 / frames["xla"] / 1e6,
        train_step_ms=step_s * 1e3, **device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""CLI driver — the analog of the reference's ``main.cpp`` /
``Application`` wiring (SURVEY.md §3 C13): build world -> build accel ->
wire camera/lights -> render / animate / train / bench.

Subcommands:
  render   one frame of a named config -> PNG
  animate  N frames along a scripted camera path -> PNGs (+ fps metric)
  train    inverse-rendering fit of a soft grid to rendered targets
  bench    Mrays/s/chip + fps metrics as JSON lines
  info     platform report (devices, device memory)

Examples:
  python -m vxtpu render  --config c2_128_lit --out /tmp/frame.png
  python -m vxtpu animate --config c1_64_flat --frames 24 --out /tmp/anim
  python -m vxtpu train   --dims 48 --steps 60 --out /tmp/fit
  python -m vxtpu bench   --config c3_256_shadows
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import numpy as np


def _build_scene(cfg, dims=None, accel_kind="distfield"):
    """World + accel + camera + lights for a SceneConfig."""
    import jax.numpy as jnp

    from vxtpu.camera.camera import Camera
    from vxtpu.world import distfield, procgen
    from vxtpu.world.lights import Lights
    from vxtpu.world.pyramid import build_pyramid

    dims = dims or cfg.dims
    grid = procgen.terrain(dims, seed=cfg.seed, with_rgb=cfg.with_rgb)
    if accel_kind == "distfield":
        accel = distfield.build(grid.occupancy, cap=24)
    elif accel_kind == "pyramid":
        accel = build_pyramid(grid.occupancy, max(cfg.settings.pyramid_levels, 2))
    else:
        accel = None
    X, Y, Z = dims
    cam = Camera.make(
        pos=(-0.7 * X, 0.5 * Y, 1.1 * Z), fov_y_deg=55.0
    ).look_at((0.5 * X, 0.5 * Y, 0.27 * Z))
    if cfg.lights > 0:
        lights = Lights.single((0.2 * X, -0.3 * Y, 1.4 * Z), intensity=2.0)
    else:
        lights = Lights.none()
    return grid, accel, cam, lights


def _kernel_factory(name: str, image_shape=None):
    """March factory for --kernel. image_shape=(H, W) lets the triton
    march cut the frame's rays into image tiles (render/kernel_triton.py);
    the other marches ignore it."""
    if name == "ref":
        from vxtpu.render.kernel_ref import make_march_ref

        return make_march_ref
    if name == "triton":
        import functools

        from vxtpu.render.kernel_triton import make_march_triton

        return functools.partial(make_march_triton, image_shape=image_shape)
    if name == "wavefront":
        from vxtpu.render.kernel_wavefront import make_march_wavefront

        return make_march_wavefront
    from vxtpu.render.kernel_xla import make_march_xla

    return make_march_xla


def build_frame(cfg, kernel: str, accel_kind: str = "distfield", dims=None,
                height: int = 0, width: int = 0, atlas=None):
    """(jitted frame(grid, accel, atlas) -> [H,W,3], (grid, accel, atlas))
    for a SceneConfig: the frame the render and bench subcommands run."""
    import jax

    from vxtpu.render.pipeline import render_image

    h = height or cfg.height
    w = width or cfg.width
    grid, accel, cam, lights = _build_scene(cfg, dims, accel_kind)
    factory = _kernel_factory(kernel, image_shape=(h, w))
    # world arrays are jit arguments: closed-over arrays would be inlined
    # into the program as constants
    fn = jax.jit(
        lambda g, a, at: render_image(factory, g, cam, lights, cfg.settings,
                                      h, w, a, atlas=at))
    return fn, (grid, accel, atlas)


def cmd_render(args) -> int:
    import jax

    from vxtpu.app.configs import CONFIGS
    from vxtpu.obs.log import get_logger
    from vxtpu.utils import save_png

    log = get_logger()
    cfg = CONFIGS[args.config]
    dims = (args.dims,) * 3 if args.dims else None
    h = args.height or cfg.height
    w = args.width or cfg.width
    atlas = None
    if args.atlas:
        from vxtpu.world.atlas import build_procedural_atlas

        atlas = build_procedural_atlas(tex_size=args.atlas_size)
        log.info("face-texture atlas enabled (%d materials, %dx%d texels)",
                 atlas.num_materials, args.atlas_size, args.atlas_size)
    fn, fargs = build_frame(cfg, args.kernel, args.accel, dims, h, w, atlas)
    img = jax.block_until_ready(fn(*fargs))
    save_png(args.out, img)
    log.info("wrote %s [%dx%d] config=%s", args.out, h, w, cfg.name)
    print(f"wrote {args.out} [{h}x{w}] config={cfg.name}")
    return 0


def cmd_animate(args) -> int:
    import jax

    from vxtpu.app.configs import CONFIGS
    from vxtpu.camera import paths
    from vxtpu.render.pipeline import render_image
    from vxtpu.utils import save_png

    cfg = CONFIGS[args.config]
    dims = (args.dims,) * 3 if args.dims else cfg.dims
    h = args.height or cfg.height
    w = args.width or cfg.width
    grid, accel, _, lights = _build_scene(cfg, dims, args.accel)
    X, Y, Z = dims
    cam_at = paths.orbit(
        center=(0.5 * X, 0.5 * Y, 0.3 * Z),
        radius=0.9 * X,
        height=1.1 * Z,
        period=args.frames / 24.0,
    )
    factory = _kernel_factory(args.kernel, image_shape=(h, w))

    @jax.jit
    def frame(g, a, t):
        return render_image(
            factory, g, cam_at(t), lights, cfg.settings, h, w, a
        )

    os.makedirs(args.out, exist_ok=True)
    # frame encode+IO runs on the native C++ worker pool so disk latency
    # never serializes into the render loop (native/framesink.cpp — the
    # runtime analog of the reference's draw/present tail); without a C++
    # toolchain frames are written inline by utils.save_png.
    from vxtpu.native.framesink import FrameSink, framesink_available

    sink = FrameSink(workers=2) if framesink_available() else None
    t_render = 0.0
    try:
        for i in range(args.frames):
            t0 = time.perf_counter()
            img = jax.block_until_ready(frame(grid, accel, i / 24.0))
            if i > 0:  # skip compile frame
                t_render += time.perf_counter() - t0
            path = os.path.join(args.out, f"frame_{i:04d}.png")
            if sink is not None:
                sink.submit(path, np.asarray(img))
            else:
                save_png(path, img)
    finally:
        if sink is not None:
            failed = sink.flush()
            sink.close()
            if failed:
                raise IOError(f"{failed} frames failed to write")
    steady = args.frames - 1
    if steady > 0 and t_render > 0:
        fps = steady / t_render
        print(json.dumps({"metric": "fps", "value": round(fps, 2),
                          "frames": args.frames, "res": [h, w],
                          "sink": "native" if sink is not None else "python"}))
    print(f"wrote {args.frames} frames to {args.out}/")
    return 0


def cmd_train(args) -> int:
    """Config 4: inverse-rendering fit. Honors --config (c4_512_diff scaled
    by --dims/--height/--width), multi-view capture (--views N), --resume,
    and the custom-VJP fast path (--custom-vjp)."""
    import jax.numpy as jnp

    from vxtpu.app.configs import CONFIGS
    from vxtpu.camera import paths
    from vxtpu.camera.camera import Camera
    from vxtpu.render.soft import SoftGrid, render_soft_image
    from vxtpu.train.checkpoint import (load_checkpoint, load_opt_state,
                                        save_checkpoint)
    from vxtpu.train.loop import (TrainConfig, fit_soft, fit_soft_views,
                                  make_optimizer)
    from vxtpu.utils import save_png
    from vxtpu.world import procgen

    cfg = CONFIGS[args.config]
    if not cfg.soft:
        raise SystemExit(f"config {cfg.name} is not a soft/differentiable "
                         "config; use c4_512_diff or c5_1080p_pod")
    dims = (args.dims,) * 3 if args.dims else cfg.dims
    h = args.height or cfg.height
    w = args.width or cfg.width
    samples = args.samples or cfg.num_samples
    settings = cfg.settings
    X, Y, Z = dims
    target_grid = procgen.terrain(dims, seed=cfg.seed, with_rgb=True)
    truth = SoftGrid.from_hard(target_grid)

    tc = TrainConfig(steps=args.steps, num_samples=samples,
                     ray_batch=args.ray_batch, seed=cfg.seed,
                     use_custom_vjp=args.custom_vjp,
                     occ_mask=args.occmask)
    start_step = 0
    soft = SoftGrid.zeros(dims)
    opt_state = None
    if args.resume:
        soft, _, start_step, _ = load_checkpoint(args.resume)
        tc = TrainConfig(steps=max(args.steps - start_step, 0),
                         num_samples=samples, ray_batch=args.ray_batch,
                         seed=cfg.seed + start_step,
                         use_custom_vjp=args.custom_vjp,
                         occ_mask=args.occmask)
        # adam moments resume too (None for pre-opt-state checkpoints)
        opt_state = load_opt_state(args.resume, make_optimizer(tc).init(soft))

    log = lambda i, l: print(f"step {start_step + i:5d}  loss {l:.6f}")
    if args.views > 1:
        cams = paths.orbit_views(
            center=(0.5 * X, 0.5 * Y, 0.3 * Z), radius=0.9 * X,
            height=1.1 * Z, n=args.views, fov_y_deg=55.0)
        target = jnp.stack([
            render_soft_image(truth, c, settings, h, w, samples)
            for c in cams
        ])
        soft, losses, opt_state = fit_soft_views(soft, cams, target, settings,
                                                 tc, log_fn=log,
                                                 opt_state=opt_state)
        cam_out, view0 = cams[0], target[0]
    else:
        cam_out = Camera.make(pos=(-0.7 * X, 0.5 * Y, 1.1 * Z)).look_at(
            (0.5 * X, 0.5 * Y, 0.27 * Z))
        view0 = render_soft_image(truth, cam_out, settings, h, w, samples)
        soft, cam_out, losses, opt_state = fit_soft(soft, cam_out, view0,
                                                    settings, tc, log_fn=log,
                                                    opt_state=opt_state)

    os.makedirs(args.out, exist_ok=True)
    if args.checkpoint:
        save_checkpoint(os.path.join(args.out, "ckpt.npz"), soft, cam_out,
                        step=start_step + tc.steps,
                        extra={"losses": np.asarray(losses)},
                        opt_state=opt_state)
    final = render_soft_image(soft, cam_out, settings, h, w, samples)
    save_png(os.path.join(args.out, "target.png"), view0)
    save_png(os.path.join(args.out, "fit.png"), final)
    print(json.dumps({"metric": "final_loss",
                      "value": losses[-1] if losses else None,
                      "losses": losses,
                      "steps": start_step + tc.steps, "views": args.views}))
    return 0


def cmd_config5(args) -> int:
    """Config 5 (BASELINE configs[4]): animated scene, rays sharded over the
    mesh, camera-pose + voxel gradient descent per frame. --multihost joins
    a pod-slice SPMD job first (every host runs this same command)."""
    from vxtpu.app.configs import CONFIGS
    from vxtpu.engine.platform import init_multihost, validate_platform
    from vxtpu.obs.metrics import MetricsSink
    from vxtpu.train.config5 import Config5, run_config5

    if args.multihost:
        init_multihost()
    cfg5 = Config5(
        dims=(args.dims,) * 3 if args.dims else (512, 512, 512),
        height=args.height or 1080, width=args.width or 1920,
        num_samples=args.samples or 192, frames=args.frames,
        steps_per_frame=args.steps_per_frame,
    )
    settings = CONFIGS["c5_1080p_pod"].settings
    validate_platform()
    sink = MetricsSink(path=os.path.join(args.out, "metrics.jsonl")
                       if args.out else None)
    res = run_config5(cfg5, settings, out_dir=args.out, resume=args.resume,
                      sink=sink, save_frames=args.save_frames)
    print(json.dumps({
        "metric": "config5_final_psnr", "value": res["psnrs"][-1],
        "frames": cfg5.frames, "final_loss": res["losses"][-1],
        "yaw_err": res["yaw_err"], "pitch_err": res["pitch_err"],
    }))
    return 0


def time_frames(frame, fargs, iters: int):
    """(compile seconds, [warm frame seconds]) — each warm frame ends in
    block_until_ready, so the host clock covers the device work."""
    import jax

    t0 = time.perf_counter()
    compiled = frame.lower(*fargs).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*fargs))            # warm-up run
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*fargs))
        times.append(time.perf_counter() - t0)
    return compile_s, times


def cmd_bench(args) -> int:
    import contextlib

    import jax

    from vxtpu.app.configs import CONFIGS
    from vxtpu.obs.metrics import MetricsSink, mrays_per_s

    cfg = CONFIGS[args.config]
    dims = (args.dims,) * 3 if args.dims else cfg.dims
    h = args.height or cfg.height
    w = args.width or cfg.width
    frame, fargs = build_frame(cfg, args.kernel, args.accel, dims, h, w)
    prof = (jax.profiler.trace(args.profile)
            if args.profile else contextlib.nullcontext())
    with prof:
        compile_s, times = time_frames(frame, fargs, args.iters)
    dt = statistics.median(times)
    dev = jax.devices()[0]
    MetricsSink().emit(
        metric=f"Mrays/s @ {cfg.name} {dims[0]}^3 {h}x{w}",
        value=mrays_per_s(h, w, dt), unit="Mrays/s", frame_ms=dt * 1e3,
        frame_ms_all=[t * 1e3 for t in times], compile_s=compile_s,
        kernel=args.kernel, device=dev.device_kind, platform=dev.platform,
        profile=args.profile or None)
    return 0


def cmd_scaling(args) -> int:
    """Rays/s at 1..N devices + parallel efficiency (BASELINE: "scaling
    measured at 1 chip, 1 host, N>=2 hosts"; >=90% linear target). On a
    one-device machine, run under XLA_FLAGS=--xla_force_host_platform_
    device_count=8 JAX_PLATFORMS=cpu to exercise the sharded path."""
    import jax

    from vxtpu.app.configs import CONFIGS
    from vxtpu.engine.sharding import make_mesh, render_image_sharded
    from vxtpu.obs.metrics import MetricsSink, mrays_per_s

    cfg = CONFIGS[args.config]
    dims = (args.dims,) * 3 if args.dims else cfg.dims
    h = args.height or cfg.height
    w = args.width or cfg.width
    grid, accel, cam, lights = _build_scene(cfg, dims, args.accel)
    factory = _kernel_factory(args.kernel, image_shape=(h, w))
    sink = MetricsSink()

    n_max = len(jax.devices())
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_max]
    if counts[-1] != n_max:
        counts.append(n_max)
    base = None
    for n in counts:
        mesh = make_mesh(n)

        @jax.jit
        def frame(g, a, mesh=mesh):
            return render_image_sharded(factory, g, cam, lights,
                                        cfg.settings, h, w, mesh, a)

        _, times = time_frames(frame, (grid, accel), args.iters)
        dt = statistics.median(times)
        mrays = mrays_per_s(h, w, dt)
        if base is None:
            base = mrays
        eff = mrays / (base * n)
        sink.emit(metric="scaling", devices=n, mrays=round(mrays, 3),
                  efficiency=round(eff, 4), fps=round(1.0 / dt, 2))
    return 0


def cmd_info(args) -> int:
    from vxtpu.engine.platform import platform_report

    print(json.dumps(platform_report(), indent=2, default=str))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vxtpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, config=True):
        if config:
            sp.add_argument("--config", default="c1_64_flat")
        sp.add_argument("--dims", type=int, default=0,
                        help="override grid side length (cube)")
        sp.add_argument("--height", type=int, default=0)
        sp.add_argument("--width", type=int, default=0)
        sp.add_argument("--accel", choices=["distfield", "pyramid", "none"],
                        default="distfield")
        sp.add_argument("--kernel",
                        choices=["triton", "xla", "wavefront", "ref"],
                        default="triton",
                        help="march: triton (per-ray GPU kernel, the "
                             "fastest; needs --accel distfield), xla "
                             "(lock-step XLA loop), wavefront, ref "
                             "(per-ray oracle)")

    sp = sub.add_parser("render", help="render one frame to PNG")
    common(sp)
    sp.add_argument("--atlas", action="store_true",
                    help="face-texture hits from a procedural atlas (C17)")
    sp.add_argument("--atlas-size", type=int, default=16,
                    help="atlas texels per voxel face edge")
    sp.add_argument("--out", default="/tmp/vxtpu_frame.png")
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("animate", help="render an orbit animation")
    common(sp)
    sp.add_argument("--frames", type=int, default=24)
    sp.add_argument("--out", default="/tmp/vxtpu_anim")
    sp.set_defaults(fn=cmd_animate)

    sp = sub.add_parser("train", help="inverse-rendering fit (config 4)")
    sp.add_argument("--config", default="c4_512_diff")
    sp.add_argument("--dims", type=int, default=48,
                    help="override grid side (0 = config's full dims)")
    sp.add_argument("--height", type=int, default=96)
    sp.add_argument("--width", type=int, default=96)
    sp.add_argument("--steps", type=int, default=100)
    sp.add_argument("--samples", type=int, default=96,
                    help="0 = config's num_samples")
    sp.add_argument("--ray-batch", type=int, default=0)
    sp.add_argument("--views", type=int, default=1,
                    help=">1: multi-view orbit capture (config 4 'images')")
    sp.add_argument("--occmask", action="store_true",
                    help="occupancy-mask sample skipping (masked soft "
                         "model; periodic mask refresh)")
    sp.add_argument("--custom-vjp", action="store_true",
                    help="render via the O(N+grid) custom-VJP fast path")
    sp.add_argument("--no-checkpoint", dest="checkpoint",
                    action="store_false",
                    help="skip writing ckpt.npz (grid + adam moments)")
    sp.add_argument("--resume", default=None, help="checkpoint .npz to resume")
    sp.add_argument("--out", default="/tmp/vxtpu_fit")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser(
        "config5", help="animated sharded per-frame optimization (config 5)")
    sp.add_argument("--dims", type=int, default=0,
                    help="override grid side (0 = 512)")
    sp.add_argument("--height", type=int, default=0)
    sp.add_argument("--width", type=int, default=0)
    sp.add_argument("--samples", type=int, default=0)
    sp.add_argument("--frames", type=int, default=24)
    sp.add_argument("--steps-per-frame", type=int, default=2)
    sp.add_argument("--multihost", action="store_true",
                    help="jax.distributed.initialize() before building the mesh")
    sp.add_argument("--resume", default=None, help="checkpoint .npz to resume")
    sp.add_argument("--save-frames", action="store_true")
    sp.add_argument("--out", default="/tmp/vxtpu_c5")
    sp.set_defaults(fn=cmd_config5)

    sp = sub.add_parser("bench", help="throughput benchmark")
    common(sp)
    sp.add_argument("--iters", type=int, default=5,
                    help="warm frames; the median is reported")
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="wrap the timed loop in jax.profiler.trace(DIR)")
    sp.set_defaults(fn=cmd_bench)

    sp = sub.add_parser("scaling",
                        help="rays/s at 1..N devices + parallel efficiency")
    common(sp)
    sp.add_argument("--iters", type=int, default=4)
    sp.set_defaults(fn=cmd_scaling)

    sp = sub.add_parser("info", help="platform report")
    sp.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    from vxtpu.engine.platform import enable_compilation_cache

    enable_compilation_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())

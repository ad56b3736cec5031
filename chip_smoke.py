"""Smoke run of vxtpu's main path on one NVIDIA GPU, at full width.

    python chip_smoke.py             # render + train phases on one card
    python chip_smoke.py --cards 4   # config-5 step on four cards vs one

One card:
  render   c5's frame (512³ terrain with per-voxel RGB, 1920x1080, full
           shading, shadows, fog) through ``python -m vxtpu render`` for the
           Triton march and the XLA march; compile time, median of warm
           frames, memory analysis, and the full-frame difference.
  march    the Triton march vs the per-ray oracle (render/kernel_ref.py) at
           512³ on a 256x256 subsample of the 1080p camera, primary rays and
           shadow rays toward the light.
  train    three c4 steps (512³ soft grid, 256x256 rays, S=256, custom VJP)
           through ``python -m vxtpu train``; forward and backward times of
           the step; custom-VJP vs autodiff gradients at 512³ in full
           float32; two identical gradient evaluations compared.
Four cards (``--cards 4``): ``run_config5`` at c5's widths (512³,
1920x1080, S=192), one frame of two steps, on a four-card mesh and on one
card; losses and one plain-SGD gradient compared.

Every phase prints its numbers; a failed phase makes the exit code 1. The
last line is a JSON object naming the device. Without a GPU the script
exits 2 before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import traceback

C5 = "c5_1080p_pod"
C4 = "c4_512_diff"
SUBSAMPLE = 256          # rays per side of the oracle comparison
WARM_FRAMES = 5

# Tolerances. A ray that grazes a voxel edge can pass it on either side in
# float32: the oracle's incremental t_next gathers rounding over hundreds of
# steps at 512³, the march restarts from o + t*d after each jump, and the
# GPU compilers may contract a*b+c. So both bounds are shares of rays: hit
# agreement, and among rays both hit, the same voxel with t to rtol 1e-4,
# atol 1e-3. (At this scene's 128x128 subsample on the CPU, the float32
# oracle itself agrees with a float64 oracle on 99.906% of hit voxels.)
MIN_HIT_AGREEMENT = 0.998
MIN_SURFACE_AGREEMENT = 0.998
T_RTOL, T_ATOL = 1e-4, 1e-3
# Full frame, Triton vs XLA march: the same hit rule, so pixels differ only
# on such edge rays; allow that share of pixels to differ by > 2/255.
MAX_PIXEL_MISMATCH = 0.002
# Gradients in float32 (matmul precision "highest"): the custom VJP sums
# the same terms as autodiff in another order, with atomics.
MAX_GRAD_REL_L2 = 1e-3
# Four cards vs one: the gradient is a psum of four bucketed partial sums
# per card, summed in float32 in another order than on one card. In the lit
# mode the sigma gradient (through the density-gradient normals) is a sum
# of millions of terms that largely cancel, which magnifies rounding: the
# first four-card run measured 1.3e-4 for sigma, 6.5e-8 for rgb. The bound
# is the one the custom VJP is held to against autodiff.
MAX_SHARDED_LOSS_RTOL = 1e-3
MAX_SHARDED_GRAD_REL_L2 = MAX_GRAD_REL_L2


def _say(**kv):
    print(json.dumps(kv, default=float), flush=True)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _memory(compiled) -> dict:
    m = compiled.memory_analysis()
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")}


def _peak_bytes() -> int:
    import jax

    return int(jax.devices()[0].memory_stats()["peak_bytes_in_use"])


def _rel_l2(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cli(argv) -> str:
    """Run ``python -m vxtpu <argv>`` in this process; its stdout."""
    from vxtpu.app.run import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    out = buf.getvalue()
    print(out, end="", flush=True)
    if rc != 0:
        raise RuntimeError(f"vxtpu {' '.join(argv)} exited {rc}")
    return out


def phase_render(tmp: str) -> None:
    import jax
    import numpy as np

    from vxtpu.app.configs import CONFIGS
    from vxtpu.app.run import build_frame, time_frames

    cfg = CONFIGS[C5]
    images = {}
    for kernel in ("triton", "xla"):
        png = os.path.join(tmp, f"c5_{kernel}.png")
        _cli(["render", "--config", C5, "--kernel", kernel, "--out", png])
        if os.path.getsize(png) < 1000:
            raise RuntimeError(f"{png} is too small to be a frame")
        frame, fargs = build_frame(cfg, kernel)
        compile_s, times = time_frames(frame, fargs, WARM_FRAMES)
        compiled = frame.lower(*fargs).compile()
        img = np.asarray(jax.block_until_ready(compiled(*fargs)))
        if img.shape != (cfg.height, cfg.width, 3) or not np.isfinite(
                img).all():
            raise RuntimeError(f"{kernel} frame: shape {img.shape} or "
                               "non-finite pixels")
        images[kernel] = img
        _say(phase="render", kernel=kernel, config=C5,
             frame_ms_median=statistics.median(times) * 1e3,
             frame_ms=[t * 1e3 for t in times], compile_s=compile_s,
             memory=_memory(compiled), peak_bytes_in_use=_peak_bytes())
        del frame, fargs, compiled
    diff = np.abs(images["triton"] - images["xla"]).max(axis=-1)
    mismatch = float((diff > 2.0 / 255.0).mean())
    _say(phase="render_parity", max_abs_pixel_diff=float(diff.max()),
         mean_abs_pixel_diff=float(diff.mean()), pixels_off_by_2_255=mismatch,
         tolerance=f"share of pixels off by > 2/255 <= {MAX_PIXEL_MISMATCH}")
    if mismatch > MAX_PIXEL_MISMATCH:
        raise RuntimeError(f"triton vs xla frame: {mismatch} of pixels "
                           "differ")


def _compare_hits(name, against, ref, tri) -> None:
    import numpy as np

    h_r, h_t = np.asarray(ref.hit), np.asarray(tri.hit)
    agree = float((h_r == h_t).mean())
    both = h_r & h_t
    t_r, t_t = np.asarray(ref.t)[both], np.asarray(tri.t)[both]
    same = (np.isclose(t_t, t_r, rtol=T_RTOL, atol=T_ATOL)
            & (np.asarray(ref.voxel)[both]
               == np.asarray(tri.voxel)[both]).all(-1))
    surface = float(same.mean()) if both.any() else 1.0
    _say(phase="march_parity", rays=name, against=against, n=int(h_r.size),
         hit_rate=float(h_r.mean()), hit_agreement=agree,
         surface_agreement=surface, rays_off=int((~same).sum()),
         max_abs_t_diff=float(np.abs(t_t - t_r).max()) if both.any() else 0.0,
         tolerance=f"hit agreement >= {MIN_HIT_AGREEMENT}; same voxel and t "
                   f"(rtol {T_RTOL}, atol {T_ATOL}) on >= "
                   f"{MIN_SURFACE_AGREEMENT} of rays both hit")
    if agree < MIN_HIT_AGREEMENT or surface < MIN_SURFACE_AGREEMENT:
        raise RuntimeError(f"{name}: triton march disagrees with {against}")


def phase_march() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from vxtpu.app.configs import CONFIGS
    from vxtpu.app.run import _build_scene
    from vxtpu.camera.rays import generate_rays
    from vxtpu.render.kernel_ref import make_march_ref
    from vxtpu.render.kernel_triton import make_march_triton
    from vxtpu.render.kernel_xla import make_march_xla
    from vxtpu.render.shade import _SHADOW_EPS

    cfg = CONFIGS[C5]
    grid, accel, cam, lights = _build_scene(cfg)
    occ = grid.occupancy.reshape(-1)
    o, d = generate_rays(cam, cfg.height, cfg.width)
    rows = np.linspace(0, cfg.height - 1, SUBSAMPLE).astype(np.int32)
    cols = np.linspace(0, cfg.width - 1, SUBSAMPLE).astype(np.int32)
    idx = jnp.asarray((rows[:, None] * cfg.width + cols[None, :]).ravel())
    o, d = o[idx], d[idx]

    ref_march = jax.jit(make_march_ref(occ, cfg.dims, cfg.settings))
    xla_march = jax.jit(make_march_xla(occ, cfg.dims, cfg.settings, accel))
    tri_prim = jax.jit(make_march_triton(occ, cfg.dims, cfg.settings, accel,
                                         image_shape=(SUBSAMPLE, SUBSAMPLE)))
    ref = ref_march(o, d)
    tri = tri_prim(o, d)
    _compare_hits("primary", "oracle", ref, tri)
    # the XLA march runs the same jump rule
    _compare_hits("primary", "xla march", xla_march(o, d), tri)

    # shadow rays from the oracle's hit points toward the light, ending at
    # the light (render/pipeline.shadow_visibility)
    hit = np.asarray(ref.hit)
    p = (o + ref.t[:, None] * d + ref.normal * _SHADOW_EPS)[hit]
    lvec = lights.pos[0][None, :] - p
    dist = jnp.linalg.norm(lvec, axis=-1)
    ldir = lvec / dist[:, None]
    t_max = dist - 2.0 * _SHADOW_EPS
    tri_flat = jax.jit(make_march_triton(occ, cfg.dims, cfg.settings, accel))
    _compare_hits("shadow", "oracle", ref_march(p, ldir, t_max=t_max),
                  tri_flat(p, ldir, t_max=t_max))


def phase_train(tmp: str) -> None:
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vxtpu.app.configs import CONFIGS
    from vxtpu.app.run import time_frames
    from vxtpu.camera.camera import Camera
    from vxtpu.camera.rays import generate_rays
    from vxtpu.render.soft import SoftGrid, render_soft_image, render_soft_rays
    from vxtpu.render.vjp import render_soft_rays_fast
    from vxtpu.train.loop import (TrainConfig, loss_fn, make_optimizer,
                                  make_train_step)
    from vxtpu.world import procgen

    # (1) three steps through the CLI
    out = _cli(["train", "--config", C4, "--dims", "0", "--samples", "0",
                "--height", "256", "--width", "256", "--custom-vjp",
                "--steps", "3", "--no-checkpoint",
                "--out", os.path.join(tmp, "fit")])
    losses = json.loads(out.strip().splitlines()[-1])["losses"]
    _say(phase="train_cli", config=C4, losses=losses)
    if len(losses) != 3 or not all(np.isfinite(losses)) \
            or not losses[-1] < losses[0]:
        raise RuntimeError(f"c4 losses not finite and falling: {losses}")

    # (2) the same step, timed: forward, forward+backward, whole step
    cfg = CONFIGS[C4]
    X, Y, Z = cfg.dims
    h = w = 256
    truth = SoftGrid.from_hard(procgen.terrain(cfg.dims, seed=cfg.seed,
                                               with_rgb=True))
    cam = Camera.make(pos=(-0.7 * X, 0.5 * Y, 1.1 * Z)).look_at(
        (0.5 * X, 0.5 * Y, 0.27 * Z))
    o, d = generate_rays(cam, h, w)
    target = jax.jit(lambda s: render_soft_image(
        s, cam, cfg.settings, h, w, cfg.num_samples))(truth).reshape(-1, 3)
    tc = TrainConfig(num_samples=cfg.num_samples, use_custom_vjp=True)

    def lf(s):
        return loss_fn(s, cam, o, d, target, (h, w), cfg.settings, tc)

    soft = SoftGrid.zeros(cfg.dims)
    c_fwd, ts = time_frames(jax.jit(lf), (soft,), WARM_FRAMES)
    t_fwd = statistics.median(ts)
    c_vg, ts = time_frames(jax.jit(jax.value_and_grad(lf)), (soft,),
                           WARM_FRAMES)
    t_vg = statistics.median(ts)
    step = make_train_step(cam, (h, w), cfg.settings, tc)
    opt_state = make_optimizer(tc).init(soft)
    compiled = step.lower(soft, opt_state, o, d, target).compile()
    params, st = soft, opt_state
    ts = []
    for _ in range(WARM_FRAMES + 1):          # first run is the warm-up
        t0 = time.perf_counter()
        params, st, loss = compiled(params, st, o, d, target)
        jax.block_until_ready(loss)
        ts.append(time.perf_counter() - t0)
    _say(phase="train_step", config=C4, rays=h * w,
         samples=cfg.num_samples, forward_ms=t_fwd * 1e3,
         forward_backward_ms=t_vg * 1e3, backward_ms=(t_vg - t_fwd) * 1e3,
         step_ms_median=statistics.median(ts[1:]) * 1e3,
         compile_s={"forward": c_fwd, "forward_backward": c_vg},
         memory=_memory(compiled), peak_bytes_in_use=_peak_bytes())
    del params, st, compiled, step, opt_state

    # (3) custom-VJP vs autodiff at 512³, full float32, on a ray batch
    key = jax.random.PRNGKey(cfg.seed)
    k1, k2, k3 = jax.random.split(key, 3)
    test = SoftGrid(
        sigma_raw=truth.sigma_raw + jax.random.normal(k1, cfg.dims),
        rgb_raw=truth.rgb_raw + jax.random.normal(k2, (3, *cfg.dims)))
    sel = jax.random.choice(k3, h * w, (4096,), replace=False)
    ob, db, tb = o[sel], d[sel], target[sel]

    def loss_fast(s):
        pred = render_soft_rays_fast(s, ob, db, cfg.settings,
                                     cfg.num_samples)
        return jnp.mean((pred - tb) ** 2)

    def loss_auto(s):
        pred, _ = render_soft_rays(s, ob, db, cfg.settings, cfg.num_samples)
        return jnp.mean((pred - tb) ** 2)

    with jax.default_matmul_precision("highest"):
        g_fast = jax.jit(jax.grad(loss_fast))(test)
        g_auto = jax.jit(jax.grad(loss_auto))(test)
        errs = {k: _rel_l2(getattr(g_fast, k), getattr(g_auto, k))
                for k in ("sigma_raw", "rgb_raw")}
        del g_auto
        g_again = jax.jit(jax.grad(loss_fast))(test)
        det = {k: float(jnp.max(jnp.abs(getattr(g_fast, k)
                                        - getattr(g_again, k))))
               for k in ("sigma_raw", "rgb_raw")}
    _say(phase="grad_parity", config=C4, rays=int(sel.size),
         rel_l2_custom_vjp_vs_autodiff=errs,
         tolerance=f"rel L2 <= {MAX_GRAD_REL_L2}",
         determinism_max_abs_diff_two_runs=det,
         peak_bytes_in_use=_peak_bytes())
    if max(errs.values()) > MAX_GRAD_REL_L2:
        raise RuntimeError(f"custom VJP vs autodiff: rel L2 {errs}")


def phase_cards4(n_cards: int) -> None:
    import jax
    import numpy as np
    import optax

    from vxtpu.app.configs import CONFIGS
    from vxtpu.camera import paths
    from vxtpu.engine.sharding import (camera_frame_rays, make_mesh,
                                       make_sharded_train_step,
                                       render_soft_image_sharded)
    from vxtpu.render.soft import SoftGrid
    from vxtpu.train.config5 import Config5, run_config5
    from vxtpu.world import procgen
    from vxtpu.world.lights import Lights

    if len(jax.devices()) < n_cards:
        raise RuntimeError(f"need {n_cards} cards, have {len(jax.devices())}")
    settings = CONFIGS[C5].settings
    cfg = Config5(frames=1, steps_per_frame=2, ckpt_every=0)
    meshes = {n_cards: make_mesh(n_cards), 1: make_mesh(1)}
    runs = {n: run_config5(cfg, settings, mesh=m) for n, m in meshes.items()}
    l_n, l_1 = runs[n_cards]["losses"], runs[1]["losses"]
    del runs

    # one plain-SGD(1.0) step: the parameter change is the gradient
    X, Y, Z = cfg.dims
    truth = SoftGrid.from_hard(procgen.terrain(cfg.dims, seed=cfg.seed,
                                               with_rgb=True),
                               sigma_solid=cfg.sigma_solid)
    lights = Lights.single((0.2 * X, -0.3 * Y, 1.4 * Z), intensity=2.0)
    cam = paths.orbit(center=(0.5 * X, 0.5 * Y, 0.3 * Z), radius=0.9 * X,
                      height=1.1 * Z, period=1.0, fov_y_deg=55.0)(0.0)
    # on the host, so that both meshes can take it
    target = np.asarray(jax.jit(lambda s: render_soft_image_sharded(
        s, cam, settings, cfg.height, cfg.width, cfg.num_samples,
        meshes[n_cards], lights=lights))(truth)).reshape(-1, 3)
    o_c, d_c = camera_frame_rays(cam, cfg.height, cfg.width)
    grads = {}
    for n, mesh in meshes.items():
        init_fn, step_fn = make_sharded_train_step(
            settings, cfg.num_samples, mesh, optimize_camera=True,
            grad_buckets=cfg.grad_buckets if n > 1 else 1, lights=lights,
            use_custom_vjp=True, optimizer=optax.sgd(1.0),
            cam_optimizer=optax.sgd(1.0))
        soft = SoftGrid.zeros(cfg.dims)
        soft1, _, _, _ = step_fn(soft, cam, init_fn(soft, cam), o_c, d_c,
                                 target)
        grads[n] = {k: np.asarray(getattr(soft1, k)) for k in
                    ("sigma_raw", "rgb_raw")}
        del soft1
    base = SoftGrid.zeros(cfg.dims)
    errs = {k: _rel_l2(grads[n_cards][k] - np.asarray(getattr(base, k)),
                       grads[1][k] - np.asarray(getattr(base, k)))
            for k in ("sigma_raw", "rgb_raw")}
    loss_rtol = float(np.max(np.abs(np.asarray(l_n) - np.asarray(l_1))
                             / np.abs(np.asarray(l_1))))
    _say(phase="cards4", cards=n_cards, dims=cfg.dims,
         rays=cfg.height * cfg.width, samples=cfg.num_samples,
         losses_sharded=l_n, losses_one_card=l_1, loss_rel_diff=loss_rtol,
         grad_rel_l2_sharded_vs_one_card=errs,
         tolerance=f"loss rel diff <= {MAX_SHARDED_LOSS_RTOL}, grad rel L2 "
                   f"<= {MAX_SHARDED_GRAD_REL_L2}",
         peak_bytes_in_use=_peak_bytes())
    if loss_rtol > MAX_SHARDED_LOSS_RTOL \
            or max(errs.values()) > MAX_SHARDED_GRAD_REL_L2:
        raise RuntimeError("four-card step disagrees with one card")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, default=1, choices=(1, 4),
                   help="4: run only the four-card config-5 phase")
    args = p.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform} devices",
              file=sys.stderr)
        return 2
    from vxtpu.engine.platform import enable_compilation_cache

    enable_compilation_cache()
    print("card:", _card_line(), flush=True)

    failed = []
    with tempfile.TemporaryDirectory() as tmp:
        if args.cards == 4:
            phases = [("cards4", lambda: phase_cards4(4))]
        else:
            phases = [("render", lambda: phase_render(tmp)),
                      ("march", phase_march),
                      ("train", lambda: phase_train(tmp))]
        for name, fn in phases:
            try:
                fn()
            except Exception:                   # report, go on, fail at exit
                traceback.print_exc()
                print(f"PHASE FAILED: {name}", flush=True)
                failed.append(name)
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

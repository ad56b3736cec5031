"""Checkpoint/resume for optimization runs (BASELINE configs 4-5).

The reference has no persistent state (world regenerated per run,
SURVEY.md §6) — checkpointing is new, normative capability for the training
configs. Format: plain numpy ``.npz`` written atomically by host 0 only.
That is sufficient and multi-host-correct here because every checkpointed
leaf (SoftGrid, camera pose) is REPLICATED across the mesh — host 0's copy
is the full state, and every host restores the same values on resume (the
CLI ``train --resume`` path). A sharding-aware orbax backend only becomes
necessary if the grid itself is ever sharded (future work, SURVEY.md §6
"ray-count scaling" extension).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from vxtpu.camera.camera import Camera
from vxtpu.render.soft import SoftGrid


def save_checkpoint(path: str, soft: SoftGrid, cam: Camera, step: int,
                    extra: dict | None = None, opt_state=None,
                    compress: bool = True) -> None:
    """Host-0-only atomic save. Arrays are gathered to host (the grid is
    replicated across the mesh, so host 0's copy is the full state).

    ``opt_state`` (any optax-state pytree) is flattened and saved leaf by
    leaf so resume continues the optimizer trajectory (adam moments) instead
    of re-warming from zero — restore with load_opt_state()."""
    try:
        if jax.process_index() != 0:
            return
    except Exception:
        pass
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    payload = dict(
        sigma_raw=np.asarray(soft.sigma_raw),
        rgb_raw=np.asarray(soft.rgb_raw),
        cam_pos=np.asarray(cam.pos),
        cam_yaw=np.asarray(cam.yaw),
        cam_pitch=np.asarray(cam.pitch),
        cam_fov_y=np.asarray(cam.fov_y),
        step=np.asarray(step),
    )
    for k, v in (extra or {}).items():
        payload["x_" + k] = np.asarray(v)
    if opt_state is not None:
        for i, leaf in enumerate(jax.tree_util.tree_leaves(opt_state)):
            payload[f"o_{i:04d}"] = np.asarray(leaf)
    # compress=False for big grids: zlib on a 512^3 scene + adam moments
    # (~6.5 GB of f32) costs minutes of single-core CPU per save; the
    # uncompressed write runs at disk bandwidth
    writer = np.savez_compressed if compress else np.savez
    with open(tmp, "wb") as f:
        writer(f, **payload)
    os.replace(tmp, path)


def _migrate_rgb_layout(rgb):
    """SoftGrid.rgb_raw moved from [X,Y,Z,3] to channel-major [3,X,Y,Z]
    (see render/soft.SoftGrid). Migrate old
    checkpoints transparently; reject ambiguous shapes loudly."""
    if rgb.ndim == 4 and rgb.shape[0] == 3 and rgb.shape[-1] != 3:
        return rgb
    if rgb.ndim == 4 and rgb.shape[-1] == 3 and rgb.shape[0] != 3:
        return jnp.transpose(rgb, (3, 0, 1, 2))
    if rgb.ndim == 4 and rgb.shape[0] == 3 and rgb.shape[-1] == 3:
        raise ValueError(
            "ambiguous rgb_raw checkpoint shape %r: cannot infer layout"
            % (rgb.shape,))
    return rgb


def load_checkpoint(path: str):
    """Returns (soft, cam, step, extra)."""
    with np.load(path) as z:
        soft = SoftGrid(
            sigma_raw=jnp.asarray(z["sigma_raw"]),
            rgb_raw=_migrate_rgb_layout(jnp.asarray(z["rgb_raw"])),
        )
        cam = Camera(
            pos=jnp.asarray(z["cam_pos"]),
            yaw=jnp.asarray(z["cam_yaw"]),
            pitch=jnp.asarray(z["cam_pitch"]),
            fov_y=jnp.asarray(z["cam_fov_y"]),
        )
        step = int(z["step"])
        extra = {k[2:]: jnp.asarray(z[k]) for k in z.files if k.startswith("x_")}
    return soft, cam, step, extra


def load_opt_state(path: str, template):
    """Restore an optimizer state saved by save_checkpoint(opt_state=...).

    ``template``: a freshly-initialized opt_state with the target structure
    (e.g. ``opt.init(params)``) — npz stores leaves, not pytree structure.
    Returns the restored pytree, or None if the checkpoint predates
    opt-state saving (caller keeps the fresh template and the run re-warms,
    the documented legacy behavior)."""
    with np.load(path) as z:
        keys = sorted(k for k in z.files if k.startswith("o_"))
        if not keys:
            return None
        leaves = [z[k] for k in keys]
    tmpl_leaves, treedef = jax.tree_util.tree_flatten(template)
    if len(leaves) != len(tmpl_leaves):
        raise ValueError(
            f"checkpoint {path} has {len(leaves)} optimizer leaves but the "
            f"current optimizer expects {len(tmpl_leaves)} — config changed "
            "between save and resume")
    out = []
    for i, (l, t) in enumerate(zip(leaves, tmpl_leaves)):
        tshape = tuple(getattr(t, "shape", ()) or ())
        if tuple(l.shape) != tshape:
            raise ValueError(
                f"checkpoint {path} optimizer leaf {i} has shape "
                f"{tuple(l.shape)} but the current optimizer expects "
                f"{tshape} — model/config changed between save and resume")
        out.append(jnp.asarray(l, dtype=getattr(t, "dtype", None)))
    return jax.tree_util.tree_unflatten(treedef, out)

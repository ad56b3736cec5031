"""Config 5 driver on the virtual-device CPU mesh: animated scene, rays
sharded, camera-pose + voxel gradient descent per frame, checkpoint/resume
(BASELINE.json configs[4]). One 8-device run is shared by the tests that
read it; the full-width sharded-vs-one-card comparison is the four-card
phase of chip_smoke.py."""

import os

import jax
import numpy as np
import pytest

from vxtpu.engine.sharding import make_mesh
from vxtpu.render.settings import RenderSettings
from vxtpu.train.config5 import Config5, run_config5

CFG = Config5(dims=(16, 16, 16), height=8, width=8, num_samples=24,
              frames=3, steps_per_frame=2, fps=24.0, lr=1e-1, cam_lr=1e-2,
              pose_error=0.05, ckpt_every=2, seed=3)


def _mesh(n):
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} (virtual) devices")
    return make_mesh(n)


@pytest.fixture(scope="module")
def run8(tmp_path_factory):
    out = tmp_path_factory.mktemp("c5")
    return run_config5(CFG, RenderSettings(), mesh=_mesh(8),
                       out_dir=str(out)), out


def test_config5_runs_and_descends(run8):
    out, path = run8
    assert len(out["losses"]) == 3
    assert all(np.isfinite(out["losses"]))
    # camera pose error must shrink from the deliberate mis-init
    assert abs(out["yaw_err"]) < CFG.pose_error
    # checkpoint written (frame 2 hits ckpt_every=2, frame 3 is final)
    assert os.path.exists(path / "ckpt.npz")


def test_config5_resume(run8, tmp_path):
    _, path = run8
    ck = str(path / "ckpt.npz")
    cfg4 = Config5(**{**CFG.__dict__, "frames": 4})
    out = run_config5(cfg4, RenderSettings(), mesh=_mesh(8),
                      out_dir=str(tmp_path), resume=ck)
    # resumed at frame 3 -> exactly one more frame
    assert len(out["losses"]) == 1
    assert np.isfinite(out["losses"][0])


def test_config5_sharded_equals_single_device():
    """The whole per-frame step is sharding-invariant: a 2-way mesh and a
    1-way mesh produce the same loss trajectory (allclose)."""
    o2 = run_config5(CFG, RenderSettings(), mesh=_mesh(2))
    o1 = run_config5(CFG, RenderSettings(), mesh=_mesh(1))
    np.testing.assert_allclose(o2["losses"], o1["losses"], rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(o2["psnrs"], o1["psnrs"], rtol=2e-3)

"""Native async frame sink (native/framesink.cpp): PNG correctness via PIL
round-trip, async pool ordering/backpressure, and the animate-loop wiring."""

import os

import numpy as np
import pytest

from vxtpu.native.framesink import (FrameSink, framesink_available,
                                    write_png)

pytestmark = pytest.mark.skipif(not framesink_available(),
                                reason="no C++ toolchain for framesink")


def _gradient(h, w):
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    return np.concatenate([np.broadcast_to(y, (h, w, 1)),
                           np.broadcast_to(x, (h, w, 1)),
                           np.full((h, w, 1), 0.25)], axis=-1)


def test_sync_png_pil_roundtrip(tmp_path):
    from PIL import Image

    img = _gradient(33, 47)  # odd sizes: no alignment luck
    p = str(tmp_path / "f.png")
    write_png(p, img)
    back = np.asarray(Image.open(p))
    assert back.shape == (33, 47, 3)
    expect = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(back, expect)


def test_async_pool_writes_all_frames(tmp_path):
    from PIL import Image

    frames = [np.random.default_rng(i).random((16, 24, 3)) for i in range(20)]
    with FrameSink(workers=3, max_queue=4) as sink:
        for i, f in enumerate(frames):
            sink.submit(str(tmp_path / f"frame_{i:04d}.png"), f)
        assert sink.flush() == 0
    for i, f in enumerate(frames):
        back = np.asarray(Image.open(tmp_path / f"frame_{i:04d}.png"))
        expect = (np.clip(f, 0, 1) * 255 + 0.5).astype(np.uint8)
        np.testing.assert_array_equal(back, expect)


def test_uint8_passthrough(tmp_path):
    from PIL import Image

    img = np.arange(12 * 16 * 3, dtype=np.uint8).reshape(12, 16, 3)
    p = str(tmp_path / "u8.png")
    write_png(p, img)
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)


def test_animate_uses_native_sink(tmp_path, monkeypatch):
    """CLI animate wiring: frames written through the native sink."""
    from vxtpu.app.run import main

    # the CLI keeps no compile cache in the checkout when the variable is
    # set (engine/platform.compilation_cache_dir)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))

    out = str(tmp_path / "anim")
    rc = main(["animate", "--config", "c1_64_flat", "--dims", "16",
               "--height", "16", "--width", "16", "--frames", "3",
               "--kernel", "xla", "--out", out])
    assert rc == 0
    assert sorted(os.listdir(out)) == [f"frame_{i:04d}.png" for i in range(3)]

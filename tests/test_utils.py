"""Utilities: image writer, checkpointing, stage timer, CLI smoke."""

import os
import zlib

import numpy as np

from pbrjax.utils.image import save_render, tonemap, write_png, write_ppm
from pbrjax.utils.log import Logger, format_bytes
from pbrjax.utils.profiling import StageTimer


def test_format_bytes():
    assert format_bytes(512) == "512.00 B"
    assert format_bytes(2048) == "2.00 KiB"
    assert format_bytes(5 * 1024 * 1024) == "5.00 MiB"


def test_tonemap_range():
    img = np.array([[[0.0, 0.5, 4.0]]], dtype=np.float32)
    u8 = tonemap(img)
    assert u8.dtype == np.uint8
    assert u8[0, 0, 0] == 0 and u8[0, 0, 2] == 255
    assert 0 < u8[0, 0, 1] < 255


def test_png_roundtrippable(tmp_path):
    img = (np.random.RandomState(0).rand(16, 24, 3) * 255).astype(np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    raw = open(p, "rb").read()
    assert raw[:8] == b"\x89PNG\r\n\x1a\n"
    # decode IDAT and compare pixels
    i = raw.index(b"IDAT")
    ln = int.from_bytes(raw[i - 4 : i], "big")
    data = zlib.decompress(raw[i + 4 : i + 4 + ln])
    rows = np.frombuffer(data, dtype=np.uint8).reshape(16, 24 * 3 + 1)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(16, 24, 3), img)


def test_ppm(tmp_path):
    img = np.zeros((4, 5, 3), dtype=np.uint8)
    p = str(tmp_path / "x.ppm")
    write_ppm(p, img)
    assert open(p, "rb").read().startswith(b"P6\n5 4\n255\n")


def test_stage_timer():
    t = StageTimer()
    with t.span("a"):
        pass
    with t.span("a"):
        pass
    t.add("b", 0.5)
    rows = {name: (c, tot) for name, c, tot, _ in t.rows()}
    assert rows["a"][0] == 2
    assert abs(rows["b"][1] - 500.0) < 1e-6
    assert "stage" in t.table()


def test_checkpoint_roundtrip(tmp_path):
    import jax.numpy as jnp

    from pbrjax.models.pathtracer import init_frame_state
    from pbrjax.utils import checkpoint as ck

    state = init_frame_state(jnp, 64)
    state = state._replace(sample_count=state.sample_count + 5)
    p = str(tmp_path / "ckpt")
    ck.save(p, state, meta={"frames": 5})
    like = init_frame_state(jnp, 64)
    restored, meta = ck.restore(p, like)
    assert int(np.asarray(restored.sample_count)) == 5
    assert meta["frames"] == 5
    np.testing.assert_array_equal(np.asarray(restored.rgb.x), np.asarray(state.rgb.x))


def test_cli_render_smoke(tmp_path):
    from pbrjax import app

    out = str(tmp_path / "r.png")
    ck = str(tmp_path / "ck")
    app.main(
        [
            "render", "--scene", "triangle", "--frames", "2", "--size", "32",
            "--out", out, "--checkpoint", ck, "--stats",
        ]
    )
    assert os.path.exists(out)
    assert os.path.exists(os.path.join(ck, "meta.json"))
    # resume
    app.main(
        ["render", "--scene", "triangle", "--frames", "1", "--size", "32",
         "--out", out, "--checkpoint", ck]
    )
    assert os.path.exists(out)

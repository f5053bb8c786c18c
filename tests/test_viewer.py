"""Interactive viewer (pbrjax/viewer.py): scripted-key loop, camera →
progressive restart, light-move mode, terminal blit plumbing. The reference
tested this surface by hand in its Qt window (Window.cpp:178-242,
GLWidget.cpp:80-84); here the loop is scriptable and asserted."""

import io

import numpy as np

from pbrjax.scene.build import scene_from_text
from pbrjax.scene.procedural import cornell_box
from pbrjax.utils.config import CameraConfig, RenderSettings
from pbrjax.viewer import Viewer, ansi_halfblocks, downsample, tonemap_u8


def _make_viewer(**kw):
    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    settings = RenderSettings(
        width=32, height=32, samples=1, max_depth=2, max_added_depth=0,
        shadow_rays=1, anti_aliasing=0.0,
    )
    cfg = CameraConfig(eye=(0.0, 1.0, 3.2), center=(0.0, 0.0, 1.0))
    return Viewer(scene, settings, cfg, out=io.StringIO(), **kw)


def test_scripted_loop_renders_and_accumulates():
    v = _make_viewer()
    v.run(max_frames=3, keys="", draw=True)
    assert v.frame == 3
    assert v.tracer.sample_count == 3
    out = v.out.getvalue()
    assert "▀" in out and "spp" in out


def test_info_toggle_shows_stage_times():
    """'i' shows the live per-stage ms readout — the InfoWindow analog
    (VERDICT r4 item 6; reference InfoWindow.cpp:113-121)."""
    v = _make_viewer()
    v.run(max_frames=4, keys="i", draw=True)
    out = v.out.getvalue()
    assert "stages:" in out
    assert "trace" in out and "blit" in out
    assert v.stage_ms["trace"] > 0
    v = _make_viewer()
    v.run(max_frames=2, keys="", draw=False)
    assert v.tracer.sample_count == 2
    eye0 = list(v.camera.eye)
    v.run(max_frames=4, keys="w", draw=False)
    # 'w' moved the camera forward and reset the accumulator
    assert v.camera.eye != eye0
    assert v._resets >= 1
    assert v.tracer.sample_count < 4


def test_rotation_and_speed_keys():
    v = _make_viewer()
    v.handle_key("f")
    assert abs(v.camera.speed - (CameraConfig().speed + 0.1)) < 1e-9
    rx0 = v.camera.rot_x
    v.handle_key("LEFT")
    assert v.camera.rot_x != rx0
    v.handle_key("r")
    assert v.camera.rot_x == 0.0


def test_light_move_mode_moves_orb():
    v = _make_viewer()
    x0 = float(np.asarray(v.tracer.scene.lights.pos.x)[0])
    v.handle_key("l")
    assert v.move_light
    v.handle_key("d")
    x1 = float(np.asarray(v.tracer.scene.lights.pos.x)[0])
    assert abs(x1 - x0 - 0.25) < 1e-6
    assert v._resets >= 1
    # toggling back returns WASD to the camera
    v.handle_key("l")
    assert not v.move_light


def test_quit_key_stops_loop():
    v = _make_viewer()
    v.run(max_frames=100, keys="  x", draw=False)
    assert v.quit and v.frame <= 3


def test_focus_keys():
    v = _make_viewer()
    v.run(max_frames=1, keys="", draw=False)
    v.handle_key("p")
    assert v.focus > 0.0  # center pixel hits the back wall
    v.handle_key("o")
    assert v.focus == -1.0


def test_blit_helpers():
    img = np.linspace(0, 2.0, 16 * 16 * 3, dtype=np.float32).reshape(16, 16, 3)
    u8 = tonemap_u8(img, exposure=2.0)
    assert u8.dtype == np.uint8 and u8.max() == 255
    small = downsample(u8.astype(np.float32), 4, 8)
    assert small.shape == (4, 8, 3)
    txt = ansi_halfblocks(small.astype(np.uint8))
    assert txt.count("▀") == 2 * 8 and "38;2;" in txt


def test_cli_view_smoke():
    from pbrjax.app import main

    main([
        "view", "--scene", "cornell", "--size", "16", "--frames", "2",
        "--keys", "w", "--no-draw",
    ])


def test_arbitrary_pixel_focus():
    """Any-pixel focus (GLWidget.cpp:441-447 right-click analog): pick mode
    moves the crosshair with arrows; 'p' focuses at the crosshair; the API
    accepts explicit coordinates too."""
    v = _make_viewer()
    v.run(max_frames=1, keys="", draw=False)
    v.handle_key("P")
    assert v.pick_mode
    x0, y0 = v.focus_px, v.focus_py
    v.handle_key("LEFT")
    v.handle_key("UP")
    assert (v.focus_px, v.focus_py) != (x0, y0)
    v.handle_key("p")
    f_moved = v.focus
    assert f_moved > 0.0
    # Focus pick reads the PREVIOUS frame's depth (the reference reads last
    # frame's alpha channel, PathTracer.cpp:596-602) and picking restarts
    # accumulation — render a frame before picking again.
    v.render_one()
    # explicit coordinates: pick a finite-depth pixel whose first-hit
    # distance differs from the crosshair's
    depth = v.tracer.depth_image()
    finite = np.argwhere(np.isfinite(depth) & (np.abs(depth - f_moved) > 1e-3))
    py, px = finite[0]
    v.set_focus_pixel(int(px), int(py))
    assert v.focus > 0.0 and v.focus != f_moved
    # out-of-range coords clamp instead of raising
    v.set_focus_pixel(-5, 999)
    assert (v.focus_px, v.focus_py) == (0, 31)


def test_cli_eye_center_flags(tmp_path):
    """--eye/--center replace the hardcoded Cornell camera (app.py)."""
    import os

    from pbrjax.app import main

    out = str(tmp_path / "e.png")
    main([
        "render", "--scene", "cornell", "--frames", "1", "--size", "16",
        "--out", out, "--eye", "0.5,1.2,2.5", "--center", "0,0,1",
    ])
    assert os.path.exists(out)


def test_draft_then_refine_swaps_tracer():
    """Draft startup renders immediately on the cheap step and swaps to the
    production tracer once its background compile lands (viewer.py)."""
    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    settings = RenderSettings(
        width=16, height=16, samples=1, max_depth=4, max_added_depth=2,
        shadow_rays=1, bounce_loop="unroll",
    )
    v = Viewer(
        scene, settings, CameraConfig(), term_cols=16, term_rows=8,
        out=io.StringIO(), draft_startup=True,
    )
    assert v.tracer.settings.max_depth == 2  # draft step active
    v.run(max_frames=v._REFINE_AFTER_FRAMES + 1, draw=False)
    assert v._pending is not None  # refine kicked off after the draft burst
    v._pending[0].join(timeout=300)
    v.run(max_frames=v.frame + 2, draw=False)
    # Production step swapped in (PathTracer additionally auto-derives the
    # opaque-scene static flag — scene/build.py::derive_static_flags).
    from pbrjax.scene.build import derive_static_flags

    assert v.tracer.settings == derive_static_flags(scene, settings)
    assert v.tracer.sample_count >= 1


def test_overlay_toggle_keys_and_startup_breakdown(tmp_path):
    """'b'/'n' toggle the BVH/lights overlays on the displayed frame
    (the reference's View-menu runtime toggles, Window.cpp:69-106), and
    the startup breakdown artifact records the first-frame stages."""
    import json

    from pbrjax.scene.build import scene_from_text
    from pbrjax.scene.procedural import cornell_box
    from pbrjax.utils.config import RenderSettings
    from pbrjax.viewer import Viewer

    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=True)
    settings = RenderSettings(
        width=32, height=32, samples=1, max_depth=2, max_added_depth=0,
        shadow_rays=1, sky_light=(0.8, 0.9, 1.0), bounce_loop="scan",
    )
    out = io.StringIO()
    v = Viewer(scene, settings, out=out, term_cols=20, term_rows=10)
    v.run(max_frames=1, keys="", draw=True)
    base = v.tonemapped().copy()
    v.handle_key("b")
    assert v.show_bvh
    with_bvh = v.tonemapped()
    assert (with_bvh != base).any()  # overlay drew something
    v.handle_key("n")
    assert v.show_lights
    v.handle_key("b")
    assert not v.show_bvh

    p = tmp_path / "startup.json"
    v.write_startup_breakdown(str(p))
    d = json.loads(p.read_text())
    assert d["first_frame_s"] > 0 and d["init_s"] >= 0

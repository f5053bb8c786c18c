"""Camera state machine and config loader tests."""

import math

import numpy as np

from pbrjax.scene.camera import Camera, make_camera_state, pixel_dim
from pbrjax.utils.config import CameraConfig, Config, load_config


def test_basis_orthonormal():
    cam = make_camera_state(eye=(0, 1, 3), center_dir=(0, 0, 1))
    w = np.array([cam.w.x, cam.w.y, cam.w.z])
    u = np.array([cam.u.x, cam.u.y, cam.u.z])
    v = np.array([cam.v.x, cam.v.y, cam.v.z])
    for a in (w, u, v):
        assert abs(np.linalg.norm(a) - 1) < 1e-6
    assert abs(w @ u) < 1e-6 and abs(w @ v) < 1e-6 and abs(u @ v) < 1e-6
    # looking down -z per the reference's adjusted-center convention
    np.testing.assert_allclose(w, [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(u, [1, 0, 0], atol=1e-6)
    np.testing.assert_allclose(v, [0, 1, 0], atol=1e-6)


def test_pixel_dim_matches_reference_formula():
    # PathTracer.cpp:88-91: f = aspect * 2 * tan(fov/2); pxDim = f / width
    assert abs(pixel_dim(800, 600, 45.0) - ((800 / 600) * 2 * math.tan(math.radians(22.5)) / 800)) < 1e-9


def test_interactive_camera_moves_and_reset():
    updates = []
    cam = Camera(CameraConfig(eye=(1.0, 2.0, 3.0), speed=0.5), on_update=lambda: updates.append(1))
    assert cam.eye == [1.0, 2.0, 3.0]
    cam.move_up()
    assert cam.eye[1] == 2.5
    cam.move_forward()  # rot 0/0 → forward is -z (Camera.cpp:40-44)
    assert abs(cam.eye[2] - 2.5) < 1e-9
    cam.update_rotation(90, 0)  # negative rot_x snaps to 360 (Camera.cpp:199-204)
    assert cam.rot_x == 360.0
    cam.update_rotation(0, 200)  # pitch clamps at -90
    assert cam.rot_y == -90.0
    cam.reset()
    assert cam.eye == [1.0, 2.0, 3.0] and cam.rot_x == 0.0
    assert len(updates) >= 4


def test_rotation_pole_up_vector():
    cam = Camera(CameraConfig())
    cam.update_rotation(0, -90)  # look straight up: center.y == 1
    assert abs(cam.center[1] - 1.0) < 1e-9
    assert cam.up[1] == 0.0  # spherical up recompute (Camera.cpp:220-238)


def test_config_defaults_match_reference():
    c = Config()
    assert c.render.width == 800 and c.render.height == 600
    assert c.render.brdf == 1 and c.render.max_depth == 3 and c.render.max_added_depth == 5
    assert c.render.samples == 1 and c.render.shadow_rays == 0
    assert abs(c.render.anti_aliasing - 0.7) < 1e-9
    assert c.bvh.max_faces == 2 and c.bvh.sah_faces_limit == 100000
    assert c.camera.eye == (0.0, 1.0, 3.0)


def test_config_load_with_comments():
    text = """
{
  // comment line
  "render": { "max_depth": 7, "brdf": 0 },
  "window": { "width": 128, "height": 64 },
  "camera": { "eye": { "x": 5.0 }, "perspective": { "fov": 60.0 } },
  "bvh": { "max_faces": 1 },
  "logging": { "level": 0 }
}
"""
    c = load_config(text=text)
    assert c.render.max_depth == 7 and c.render.brdf == 0
    assert c.render.width == 128 and c.render.height == 64
    assert c.render.fov == 60.0
    assert c.camera.eye[0] == 5.0 and c.camera.eye[1] == 1.0
    assert c.bvh.max_faces == 1 and c.logging_level == 0


def test_settings_hashable_static():
    c = Config()
    assert hash(c.render) == hash(c.render.replace())
    assert c.render.replace(max_depth=9).max_depth == 9
    assert c.render.max_total_depth == 8

"""Phong tessellation: cubic solver, patch intersection, integration."""

import pytest

pytestmark = pytest.mark.slow

import numpy as np

from pbrjax.ops.phongtess import (
    face_is_flat,
    intersect_brute_phongtess,
    phongtess_patch_intersect,
    solve_cubic,
)
from pbrjax.ops.traverse import intersect_brute
from pbrjax.ops.vec import Vec3
from pbrjax.reference.cpu import render_cpu
from pbrjax.scene.build import scene_from_text
from pbrjax.scene.camera import make_camera_state
from pbrjax.utils.config import RenderSettings


def _roots_set(x0, x1, x2, count):
    return sorted(float(v) for v in [x0, x1, x2][: int(count)])


def test_cubic_three_roots():
    # (x-1)(x-2)(x-3) = x^3 - 6x^2 + 11x - 6
    x0, x1, x2, c = solve_cubic(np, np.float32(1), np.float32(-6), np.float32(11), np.float32(-6))
    assert int(c) == 3
    np.testing.assert_allclose(_roots_set(x0, x1, x2, c), [1, 2, 3], atol=1e-4)


def test_cubic_one_root():
    # x^3 + x + 1: one real root ≈ -0.68233
    x0, _, _, c = solve_cubic(np, np.float32(1), np.float32(0), np.float32(1), np.float32(1))
    assert int(c) == 1
    assert abs(float(x0) + 0.682328) < 1e-4


def test_quadratic_and_linear():
    # 0x^3 + x^2 - 3x + 2 = (x-1)(x-2)
    x0, x1, _, c = solve_cubic(np, np.float32(0), np.float32(1), np.float32(-3), np.float32(2))
    assert int(c) == 2
    np.testing.assert_allclose(sorted([float(x0), float(x1)]), [1, 2], atol=1e-5)
    # linear 2x - 1
    x0, _, _, c = solve_cubic(np, np.float32(0), np.float32(0), np.float32(2), np.float32(-1))
    assert int(c) == 1 and abs(float(x0) - 0.5) < 1e-6
    # no real roots: x^2 + 1
    _, _, _, c = solve_cubic(np, np.float32(0), np.float32(1), np.float32(0), np.float32(1))
    assert int(c) == 0


def _bumpy_tri_scene():
    """One triangle with diverging vertex normals → a curved patch."""
    obj = """
o bump
v -1.0 0.0 -1.0
v 1.0 0.0 -1.0
v 0.0 1.5 -1.0
vn -0.3 0.0 0.954
vn 0.3 0.0 0.954
vn 0.0 0.3 0.954
f 1//1 2//2 3//3
"""
    mtl = "newmtl m\nKd 0.5 0.6 0.7\nKs 1 1 1\nrough 1\np 1\n"
    scene, _ = scene_from_text(obj, mtl, "", use_bvh=False)
    return scene


def test_flat_detection():
    scene = _bumpy_tri_scene()
    assert not bool(face_is_flat(np, scene.tris)[0])
    flat_scene, _ = scene_from_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n", use_bvh=False
    )
    assert bool(face_is_flat(np, flat_scene.tris)[0])


def test_patch_reduces_to_triangle_at_small_alpha():
    """alpha→0 ⇒ the patch approaches the flat triangle. (alpha exactly 0
    degenerates the pencil coefficients to ~0 in f32 — the feature is
    gated on alpha > 0 at trace time instead, like the reference's
    PHONGTESS compile-time gate.)"""
    scene = _bumpy_tri_scene()
    r = np.random.RandomState(0)
    n = 2000
    o = Vec3(
        r.uniform(-0.5, 0.5, n).astype(np.float32),
        r.uniform(0.2, 1.0, n).astype(np.float32),
        np.full(n, 2.0, dtype=np.float32),
    )
    d = Vec3(
        r.uniform(-0.2, 0.2, n).astype(np.float32),
        r.uniform(-0.2, 0.2, n).astype(np.float32),
        np.full(n, -1.0, dtype=np.float32),
    )
    nrm = np.sqrt(d.x**2 + d.y**2 + d.z**2)
    d = Vec3(d.x / nrm, d.y / nrm, d.z / nrm)
    with np.errstate(all="ignore"):
        t_mt, f_mt = intersect_brute(np, o, d, scene.tris)
        t_pt, f_pt, _, _ = intersect_brute_phongtess(np, o, d, scene.tris, np.float32(0.01))
    hit = np.isfinite(t_mt)
    agree = np.isfinite(t_pt) == hit
    assert agree.mean() > 0.99
    m = hit & np.isfinite(t_pt)
    np.testing.assert_allclose(t_pt[m], t_mt[m], rtol=5e-3, atol=5e-3)


def test_curved_patch_bulges():
    """With alpha=1 and outward normals, the patch lies in front of the flat
    triangle for interior rays (the curvature bulge the feature exists for)."""
    scene = _bumpy_tri_scene()
    # Off the symmetry plane: on it the pencil's line factorization is
    # degenerate (determinant 0 -> miss), in the reference too.
    o = Vec3(np.float32([0.13]), np.float32([0.47]), np.float32([2.0]))
    dr = np.array([0.02, 0.015, -1.0], dtype=np.float32)
    dr /= np.linalg.norm(dr)
    d = Vec3(np.float32([dr[0]]), np.float32([dr[1]]), np.float32([dr[2]]))
    with np.errstate(all="ignore"):
        t_flat, _ = intersect_brute(np, o, d, scene.tris)
        t_pt, _, u, v = intersect_brute_phongtess(np, o, d, scene.tris, np.float32(1.0))
    assert np.isfinite(t_pt[0])
    assert t_pt[0] < t_flat[0]  # bulges toward the camera
    assert 0.0 <= u[0] <= 1.0 and 0.0 <= v[0] <= 1.0


def test_render_with_phongtess_smoke():
    scene = _bumpy_tri_scene()
    cam = make_camera_state(eye=(0.0, 0.5, 2.0), center_dir=(0.0, 0.0, 1.0))
    settings = RenderSettings(
        width=32, height=32, samples=1, max_depth=2, max_added_depth=0,
        shadow_rays=0, anti_aliasing=0.0, phong_tessellation=0.8,
    )
    rgb, _ = render_cpu(scene, cam, settings, frame_seed=3)
    assert np.isfinite(rgb).all()
    flat_rgb, _ = render_cpu(scene, cam, settings.replace(phong_tessellation=0.0), frame_seed=3)
    assert np.abs(rgb - flat_rgb).max() > 1e-3  # the feature changes the image


def test_jax_matches_numpy_phongtess():
    import functools

    import jax
    import jax.numpy as jnp

    from pbrjax.models.integrator import trace_rays

    scene = _bumpy_tri_scene()
    cam = make_camera_state(eye=(0.0, 0.5, 2.0), center_dir=(0.0, 0.0, 1.0))
    settings = RenderSettings(
        width=32, height=32, samples=1, max_depth=2, max_added_depth=0,
        shadow_rays=0, anti_aliasing=0.0, phong_tessellation=0.8,
    )
    rgb_np, _ = render_cpu(scene, cam, settings, frame_seed=3)
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)
    ids = jnp.arange(32 * 32, dtype=jnp.int32)
    f = jax.jit(functools.partial(trace_rays, jnp), static_argnames=("settings",))
    res = f(jscene, jcam, settings=settings, pixel_ids=ids, frame_seed=jnp.uint32(3))
    rgb_j = np.stack(
        [np.asarray(res.color.x), np.asarray(res.color.y), np.asarray(res.color.z)], -1
    ).reshape(32, 32, 3)
    d = np.abs(rgb_j - rgb_np).max(axis=-1)
    assert (d > 1e-3).mean() < 0.02

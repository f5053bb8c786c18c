"""Phong tessellation through the BVH: inflated leaf AABBs + curved leaf
dispatch must reproduce the brute patch sweep exactly.

The reference traces curved patches through its BVH by inflating leaf boxes
with patch thickness + sidedrop at build time (MathHelp.cpp:250-378) and
dispatching flat-vs-curved in the shared leaf test (pt_intersect.cl:142-176).
Here the gates are: (1) the inflated AABBs contain a dense sampling of the
patch surface, (2) BVH traversal ≡ brute force bitwise on the same backend,
(3) the rendered image with ``use_bvh=True`` equals the brute render.
"""

import numpy as np

import pytest

pytestmark = pytest.mark.slow

from pbrjax.ops.phongtess import (
    intersect_brute_phongtess,
    intersect_scene_phongtess,
    phongtess_face_aabbs,
)
from pbrjax.ops.vec import Vec3
from pbrjax.reference.cpu import render_cpu
from pbrjax.scene.build import scene_from_text
from pbrjax.scene.camera import make_camera_state
from pbrjax.utils.config import RenderSettings

ALPHA = np.float32(0.8)


def _wavy_sheet_obj(n: int = 6) -> str:
    """A tessellated wavy sheet in the z=-1 plane with smooth per-vertex
    normals — every face is a curved patch, and there are enough faces for
    the BVH to split several levels."""
    xs = np.linspace(-1.5, 1.5, n + 1)
    ys = np.linspace(-1.0, 1.5, n + 1)
    lines = ["o sheet"]
    for y in ys:
        for x in xs:
            z = -1.0 + 0.15 * np.sin(2.0 * x) * np.cos(2.0 * y)
            lines.append(f"v {x:.6f} {y:.6f} {z:.6f}")
            # analytic normal of the height field
            dzdx = 0.3 * np.cos(2.0 * x) * np.cos(2.0 * y)
            dzdy = -0.3 * np.sin(2.0 * x) * np.sin(2.0 * y)
            nrm = np.array([-dzdx, -dzdy, 1.0])
            nrm /= np.linalg.norm(nrm)
            lines.append(f"vn {nrm[0]:.6f} {nrm[1]:.6f} {nrm[2]:.6f}")
    w = n + 1
    for j in range(n):
        for i in range(n):
            a, b, c, d = (
                j * w + i + 1,
                j * w + i + 2,
                (j + 1) * w + i + 2,
                (j + 1) * w + i + 1,
            )
            lines.append(f"f {a}//{a} {b}//{b} {c}//{c}")
            lines.append(f"f {a}//{a} {c}//{c} {d}//{d}")
    return "\n".join(lines) + "\n"


MTL = "newmtl m\nKd 0.5 0.6 0.7\nKs 1 1 1\nrough 1\np 1\n"


def _scenes():
    obj = _wavy_sheet_obj()
    brute, _ = scene_from_text(obj, MTL, "", use_bvh=False)
    bvh, _ = scene_from_text(obj, MTL, "", use_bvh=True, phong_tess_alpha=float(ALPHA))
    return brute, bvh


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = Vec3(
        rng.uniform(-1.5, 1.5, n).astype(np.float32),
        rng.uniform(-1.0, 1.5, n).astype(np.float32),
        np.full(n, 1.5, dtype=np.float32),
    )
    dn = rng.normal(size=(3, n)).astype(np.float32)
    dn[2] = -np.abs(dn[2]) - 0.5  # bias toward the sheet
    dn /= np.linalg.norm(dn, axis=0, keepdims=True)
    return o, Vec3(*dn)


def test_inflated_aabbs_contain_patch():
    """MC containment: a dense (u,v) sampling of every curved patch stays
    inside its inflated AABB (the build-time bound is what makes BVH
    traversal exact)."""
    scene, _ = _scenes()
    tris = scene.tris
    p1 = tris.v0.stack(np)
    p2 = (tris.v0 + tris.e1).stack(np)
    p3 = (tris.v0 + tris.e2).stack(np)
    n1, n2, n3 = tris.n0.stack(np), tris.n1.stack(np), tris.n2.stack(np)
    bb_min, bb_max = phongtess_face_aabbs(p1, p2, p3, n1, n2, n3, ALPHA)

    from pbrjax.ops.phongtess import _tess_point

    eps = 1e-4
    for u in np.linspace(0, 1, 9):
        for v in np.linspace(0, 1 - u, 7):
            q = _tess_point(
                p1, p2, p3, n1, n2, n3, ALPHA, np.float32(u), np.float32(v)
            )
            assert (q >= bb_min - eps).all() and (q <= bb_max + eps).all(), (
                f"patch point escapes inflated AABB at u={u} v={v}"
            )


def test_bvh_phongtess_equals_brute_bitwise():
    brute_scene, bvh_scene = _scenes()
    o, d = _rays(4096, 5)
    t_b, f_b, u_b, v_b = intersect_brute_phongtess(
        np, o, d, bvh_scene.tris, ALPHA
    )  # same (leaf-ordered) triangle set, brute sweep
    t_w, f_w, u_w, v_w = intersect_scene_phongtess(np, o, d, bvh_scene, ALPHA)
    np.testing.assert_array_equal(f_w, f_b)
    np.testing.assert_array_equal(t_w, t_b)
    np.testing.assert_array_equal(u_w, u_b)
    np.testing.assert_array_equal(v_w, v_b)
    assert np.isfinite(t_b).mean() > 0.15  # the rays do hit the sheet


def test_render_bvh_phongtess_equals_brute():
    """Full render equality: swapping brute for BVH must not change the
    image (pure acceleration, same estimator)."""
    obj = _wavy_sheet_obj(4)
    settings = RenderSettings(
        width=24, height=24, samples=1, max_depth=2, max_added_depth=0,
        shadow_rays=0, anti_aliasing=0.0, phong_tessellation=float(ALPHA),
    )
    cam = make_camera_state(eye=(0.0, 0.3, 2.0), center_dir=(0.0, 0.0, 1.0))
    s_brute, _ = scene_from_text(obj, MTL, "", use_bvh=False)
    s_bvh, _ = scene_from_text(obj, MTL, "", use_bvh=True, phong_tess_alpha=float(ALPHA))
    r_brute, _ = render_cpu(s_brute, cam, settings, frame_seed=3)
    r_bvh, _ = render_cpu(s_bvh, cam, settings, frame_seed=3)
    # Triangle order differs (leaf reorder), so exact ties could flip the
    # winner — none occur in this scene; the images are identical.
    np.testing.assert_allclose(r_bvh, r_brute, rtol=0, atol=1e-6)
    assert np.abs(r_brute).sum() > 0


def test_jax_bvh_phongtess_matches_numpy():
    import functools

    import jax
    import jax.numpy as jnp

    from pbrjax.models.integrator import trace_rays

    obj = _wavy_sheet_obj(4)
    settings = RenderSettings(
        width=16, height=16, samples=1, max_depth=2, max_added_depth=0,
        shadow_rays=0, anti_aliasing=0.0, phong_tessellation=float(ALPHA),
    )
    cam = make_camera_state(eye=(0.0, 0.3, 2.0), center_dir=(0.0, 0.0, 1.0))
    scene, _ = scene_from_text(obj, MTL, "", use_bvh=True, phong_tess_alpha=float(ALPHA))
    rgb_np, foc_np = render_cpu(scene, cam, settings, frame_seed=9)

    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)
    ids = jnp.arange(16 * 16, dtype=jnp.int32)
    f = jax.jit(functools.partial(trace_rays, jnp), static_argnames=("settings",))
    res = f(jscene, jcam, settings=settings, pixel_ids=ids, frame_seed=jnp.uint32(9))
    rgb_j = np.stack(
        [np.asarray(res.color.x), np.asarray(res.color.y), np.asarray(res.color.z)], -1
    ).reshape(16, 16, 3)
    d = np.abs(rgb_j - rgb_np).max(axis=-1)
    # This scene is adversarially chaotic for cross-backend comparison:
    # every bounce ray leaves a *curved* surface, so XLA-vs-NumPy ULP drift
    # through the cubic solver + curved normal flips grazing second-bounce
    # hits into sky (measured: first-hit identical, ~5% second-bounce
    # flips). Gate: primary visibility identical, flips bounded, agreeing
    # pixels tight.
    foc_j = np.asarray(res.focus_t).reshape(16, 16)
    assert (np.isfinite(foc_j) == np.isfinite(foc_np)).all()  # primary hits identical
    assert (d > 1e-3).mean() <= 0.08, f"flips {(d > 1e-3).mean():.2%}"
    agree = d <= 1e-3
    assert agree.any() and np.abs(rgb_j - rgb_np).max(axis=-1)[agree].max() <= 1e-3


def test_bvh_phongtess_grads_flow():
    """Camera/material gradients flow through the BVH phong-tess path
    (detached search + differentiable re-eval) and are finite."""
    import functools

    import jax
    import jax.numpy as jnp

    from pbrjax.models.integrator import trace_rays
    from pbrjax.scene.types import Scene

    obj = _wavy_sheet_obj(3)
    settings = RenderSettings(
        width=8, height=8, samples=1, max_depth=2, max_added_depth=0,
        shadow_rays=0, anti_aliasing=0.0, phong_tessellation=float(ALPHA),
    )
    cam = make_camera_state(eye=(0.0, 0.3, 2.0), center_dir=(0.0, 0.0, 1.0))
    scene, _ = scene_from_text(obj, MTL, "", use_bvh=True, phong_tess_alpha=float(ALPHA))
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jcam = jax.tree_util.tree_map(jnp.asarray, cam)
    ids = jnp.arange(64, dtype=jnp.int32)

    def loss(mats, camst):
        sc = Scene(tris=jscene.tris, bvh=jscene.bvh, materials=mats, lights=jscene.lights)
        res = trace_rays(jnp, sc, camst, settings, ids, jnp.uint32(4))
        return res.color.x.sum() + res.color.y.sum() + res.color.z.sum()

    g_m, g_c = jax.jit(
        jax.grad(functools.partial(loss), argnums=(0, 1), allow_int=True)
    )(jscene.materials, jcam)
    assert np.isfinite(np.asarray(g_m.kd.x)).all()
    assert float(np.abs(np.asarray(g_m.kd.x)).sum()) > 0
    assert np.isfinite(np.asarray(g_c.eye.x)).all()


def test_cluster_phongtess_search_matches_brute():
    """The dense cluster-candidate search (the large-batch jax path,
    intersect_clusters_phongtess) must find the same winning faces as the
    brute per-face sweep on an all-curved scene."""
    import jax
    import jax.numpy as jnp

    from pbrjax.ops.phongtess import intersect_clusters_phongtess

    obj = _wavy_sheet_obj(12)  # 288 curved faces -> clusters built
    scene, _ = scene_from_text(
        obj, MTL, "", use_bvh=True, phong_tess_alpha=float(ALPHA)
    )
    assert scene.clusters is not None
    o, d = _rays(512, seed=3)
    t_b, f_b, u_b, v_b = intersect_brute_phongtess(np, o, d, scene.tris, ALPHA)

    js = jax.tree_util.tree_map(jnp.asarray, scene)
    ov = Vec3(*(jnp.asarray(a) for a in o))
    dv = Vec3(*(jnp.asarray(a) for a in d))
    f_c, u_c, v_c = intersect_clusters_phongtess(
        jnp, ov, dv, js.clusters, js.tris, ALPHA, tile=64
    )
    agree = (np.asarray(f_c) == f_b).mean()
    assert agree > 0.99, f"face agreement {agree:.4f}"  # cubic-solver ULP ties
    same = np.asarray(f_c) == f_b
    np.testing.assert_allclose(np.asarray(u_c)[same], u_b[same], atol=2e-3)

    # Dead lanes report -1 and perturb nothing.
    alive = jnp.asarray((np.arange(512) % 4) != 0)
    f_a, _, _ = intersect_clusters_phongtess(
        jnp, ov, dv, js.clusters, js.tris, ALPHA, tile=64, alive=alive
    )
    a = np.asarray(alive)
    np.testing.assert_array_equal(np.asarray(f_a)[a], np.asarray(f_c)[a])
    assert np.all(np.asarray(f_a)[~a] == -1)


def test_scene_phongtess_dispatch_uses_cluster_path():
    """At production batch sizes intersect_scene_phongtess routes through
    the cluster search; results must match the NumPy walk."""
    import jax
    import jax.numpy as jnp

    obj = _wavy_sheet_obj(12)
    scene, _ = scene_from_text(
        obj, MTL, "", use_bvh=True, phong_tess_alpha=float(ALPHA)
    )
    o, d = _rays(4608, seed=9)  # >= 4096 triggers the cluster path
    t_n, f_n, _, _ = intersect_scene_phongtess(np, o, d, scene, ALPHA)

    js = jax.tree_util.tree_map(jnp.asarray, scene)
    ov = Vec3(*(jnp.asarray(a) for a in o))
    dv = Vec3(*(jnp.asarray(a) for a in d))
    t_j, f_j, _, _ = jax.jit(
        lambda ov, dv: intersect_scene_phongtess(jnp, ov, dv, js, ALPHA)
    )(ov, dv)
    agree = (np.asarray(f_j) == f_n).mean()
    assert agree > 0.99, f"face agreement {agree:.4f}"
    same = np.asarray(f_j) == f_n
    hit = same & (f_n >= 0)
    np.testing.assert_allclose(
        np.asarray(t_j)[hit], t_n[hit], rtol=2e-3, atol=2e-4
    )

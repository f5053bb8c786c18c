"""BVH builder invariants and traversal ≡ brute-force equivalence
(SURVEY.md §7 test plan item 3)."""

import numpy as np

from pbrjax.accel.bvh import build_bvh
from pbrjax.ops.traverse import intersect_brute, intersect_bvh
from pbrjax.ops.vec import Vec3
from pbrjax.scene.build import scene_from_text
from pbrjax.scene.procedural import cornell_box, random_soup
from pbrjax.utils.config import BVHConfig


def _soup_tris(n, seed=0):
    obj_text = random_soup(n, seed=seed)
    scene, _ = scene_from_text(obj_text, use_bvh=False)
    return scene


def test_invariants_small():
    scene = _soup_tris(257)
    v0 = scene.tris.v0.stack(np)
    v1 = (scene.tris.v0 + scene.tris.e1).stack(np)
    v2 = (scene.tris.v0 + scene.tris.e2).stack(np)
    bvh, order, stats = build_bvh(v0, v1, v2, BVHConfig(max_faces=2))

    n = bvh.count
    # Every face in exactly one leaf.
    assert sorted(order.tolist()) == list(range(257))
    counts = np.asarray(bvh.leaf_count)
    firsts = np.asarray(bvh.leaf_first)
    leaf = firsts >= 0
    assert counts[leaf].sum() == 257
    assert (counts[leaf] >= 1).all() and (counts[leaf] <= 2).all()
    # Leaf face ranges are disjoint and consecutive in preorder.
    spans = sorted(zip(firsts[leaf].tolist(), counts[leaf].tolist()))
    pos = 0
    for f, c in spans:
        assert f == pos
        pos += c
    # Escape indices point strictly forward and ≤ n.
    ex = np.asarray(bvh.exit)
    assert (ex > np.arange(n)).all() and (ex <= n).all()
    # Parent AABBs contain children (walk via preorder structure).
    bmin = bvh.bb_min.stack(np)
    bmax = bvh.bb_max.stack(np)
    for i in range(n):
        if firsts[i] < 0:
            left = i + 1
            right_exit = ex[i]
            assert (bmin[i] <= bmin[left] + 1e-6).all()
            assert (bmax[i] >= bmax[left] - 1e-6).all()
    # Leaf AABBs contain their faces.
    for i in np.where(leaf)[0]:
        for k in range(counts[i]):
            f = firsts[i] + k
            fi = order[f]
            tri = np.stack([v0[fi], v1[fi], v2[fi]])
            assert (tri.min(0) >= bmin[i] - 1e-5).all()
            assert (tri.max(0) <= bmax[i] + 1e-5).all()


def _rand_rays(num, seed, spread=2.5):
    r = np.random.RandomState(seed)
    o = r.uniform(-spread, spread, size=(num, 3)).astype(np.float32)
    d = r.randn(num, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Vec3(o[:, 0], o[:, 1], o[:, 2]), Vec3(d[:, 0], d[:, 1], d[:, 2])


def test_traversal_equals_brute_force_soup():
    obj_text = random_soup(400, seed=3)
    scene, _ = scene_from_text(obj_text, use_bvh=True)
    o, d = _rand_rays(20000, seed=1)
    with np.errstate(all="ignore"):
        t1, f1 = intersect_brute(np, o, d, scene.tris)
        t2, f2 = intersect_bvh(np, o, d, scene.bvh, scene.tris, max_leaf=2)
    np.testing.assert_array_equal(np.nan_to_num(t1, nan=-1), np.nan_to_num(t2, nan=-1))
    np.testing.assert_array_equal(f1, f2)


def test_traversal_equals_brute_force_cornell_onsurface():
    """Rays originating exactly on surfaces (the slab-test NaN regression)."""
    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=True)
    r = np.random.RandomState(0)
    n = 50000
    from pbrjax.ops.intersect import gather_vec3

    faces = r.randint(0, scene.tris.count, n)
    u = r.rand(n).astype(np.float32)
    v = r.rand(n).astype(np.float32)
    m = u + v > 1
    u[m], v[m] = 1 - u[m], 1 - v[m]
    v0 = gather_vec3(scene.tris.v0, faces)
    e1 = gather_vec3(scene.tris.e1, faces)
    e2 = gather_vec3(scene.tris.e2, faces)
    o = Vec3(v0.x + e1.x * u + e2.x * v, v0.y + e1.y * u + e2.y * v, v0.z + e1.z * u + e2.z * v)
    # half random dirs, half axis-aligned (to provoke 0 * inf slab cases)
    dd = r.randn(n, 3).astype(np.float32)
    axis = np.eye(3, dtype=np.float32)[r.randint(0, 3, n)] * np.where(r.rand(n, 1) < 0.5, 1, -1)
    dd[n // 2 :] = axis[n // 2 :]
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    d = Vec3(dd[:, 0], dd[:, 1], dd[:, 2])
    with np.errstate(all="ignore"):
        t1, f1 = intersect_brute(np, o, d, scene.tris)
        t2, f2 = intersect_bvh(np, o, d, scene.bvh, scene.tris, max_leaf=2)
    np.testing.assert_array_equal(np.nan_to_num(t1, nan=-1), np.nan_to_num(t2, nan=-1))


def test_jax_bvh_matches_numpy_bvh():
    import jax
    import jax.numpy as jnp

    obj_text = random_soup(150, seed=5)
    scene, _ = scene_from_text(obj_text, use_bvh=True)
    o, d = _rand_rays(4096, seed=2)
    with np.errstate(all="ignore"):
        t1, f1 = intersect_bvh(np, o, d, scene.bvh, scene.tris, max_leaf=2)
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)
    jo = Vec3(jnp.asarray(o.x), jnp.asarray(o.y), jnp.asarray(o.z))
    jd = Vec3(jnp.asarray(d.x), jnp.asarray(d.y), jnp.asarray(d.z))
    t2, f2 = intersect_bvh(jnp, jo, jd, jscene.bvh, jscene.tris, max_leaf=2)
    # Face picks must agree except at ULP-ties; t within float tolerance.
    agree = np.asarray(f2) == f1
    assert agree.mean() > 0.999
    np.testing.assert_allclose(
        np.nan_to_num(np.asarray(t2)[agree], posinf=0),
        np.nan_to_num(t1[agree], posinf=0),
        rtol=2e-5,
        atol=2e-5,
    )


def test_mean_split_path():
    """Force the mean-split fallback (sah_faces_limit=0) and re-verify."""
    obj_text = random_soup(300, seed=9)
    scene, _ = scene_from_text(
        obj_text, use_bvh=True, bvh_cfg=BVHConfig(sah_faces_limit=0, max_faces=4)
    )
    o, d = _rand_rays(10000, seed=4)
    with np.errstate(all="ignore"):
        t1, f1 = intersect_brute(np, o, d, scene.tris)
        t2, f2 = intersect_bvh(np, o, d, scene.bvh, scene.tris, max_leaf=4)
    np.testing.assert_array_equal(np.nan_to_num(t1, nan=-1), np.nan_to_num(t2, nan=-1))


def test_skip_ahead_traversal_equals_brute_force():
    """Skip-ahead elision (BVH.cpp:770-795 + PathTracer.cpp:250-307): the
    serialized stream drops inner left children whose SA is close to their
    parent's, shrinking the node buffer while traversal stays exact."""
    obj_text = random_soup(400, seed=3)
    scene_plain, _ = scene_from_text(obj_text, use_bvh=True)
    scene_skip, _ = scene_from_text(
        obj_text, use_bvh=True, bvh_cfg=BVHConfig(skip_ahead=True)
    )
    assert scene_skip.bvh.count < scene_plain.bvh.count
    o, d = _rand_rays(20000, seed=7)
    with np.errstate(all="ignore"):
        t1, f1 = intersect_brute(np, o, d, scene_skip.tris)
        t2, f2 = intersect_bvh(np, o, d, scene_skip.bvh, scene_skip.tris, max_leaf=2)
    np.testing.assert_array_equal(np.nan_to_num(t1, nan=-1), np.nan_to_num(t2, nan=-1))
    np.testing.assert_array_equal(f1, f2)


def test_skip_ahead_invariants():
    """Escape indices stay strictly forward and leaves keep every face."""
    scene = _soup_tris(257)
    v0 = scene.tris.v0.stack(np)
    v1 = (scene.tris.v0 + scene.tris.e1).stack(np)
    v2 = (scene.tris.v0 + scene.tris.e2).stack(np)
    bvh, order, stats = build_bvh(
        v0, v1, v2, BVHConfig(max_faces=2, skip_ahead=True)
    )
    assert stats.num_skipped > 0
    assert bvh.count == stats.num_nodes
    n = bvh.count
    assert sorted(order.tolist()) == list(range(257))
    counts = np.asarray(bvh.leaf_count)
    leaf = np.asarray(bvh.leaf_first) >= 0
    assert counts[leaf].sum() == 257
    ex = np.asarray(bvh.exit)
    assert (ex > np.arange(n)).all() and (ex <= n).all()


def test_adaptive_leaf_size_big_scene():
    """Scenes over 20k faces build 64-face leaves (scene/build.py) and
    bvh_max_leaf reports the matching static traversal bound."""
    from pbrjax.scene.build import bvh_max_leaf, scene_from_text
    from pbrjax.scene.procedural import random_soup

    scene, _ = scene_from_text(random_soup(21_000, seed=2), use_bvh=True)
    ml = bvh_max_leaf(scene)
    assert 2 < ml <= 64
    assert int(np.max(np.asarray(scene.bvh.leaf_count))) == ml
    # Small scenes keep the reference's 2-face leaves.
    small, _ = scene_from_text(random_soup(500, seed=2), use_bvh=True)
    assert bvh_max_leaf(small) == 2

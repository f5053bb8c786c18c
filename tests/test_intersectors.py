"""Cross-checks between the intersector implementations (fori_loop and
broadcast brute sweeps, BVH walk), the platform dispatch, and the differentiable re-evaluation
contract."""

import numpy as np
import pytest

from pbrjax.ops import traverse
from pbrjax.ops.traverse import (
    GPU_BRUTE_MAX_FACES,
    intersect_brute,
    intersect_brute_dense,
    intersect_bvh,
    intersect_scene,
    select_intersector,
)
from pbrjax.ops.vec import Vec3
from pbrjax.scene.build import LARGE_SCENE_LEAF, scene_from_text
from pbrjax.scene.procedural import cornell_box, random_soup


def _rays(n, seed=0):
    r = np.random.RandomState(seed)
    o = r.uniform(-2, 3, size=(3, n)).astype(np.float32)
    d = r.randn(3, n).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return Vec3(*o), Vec3(*d)


@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_dense_matches_brute(backend):
    """The broadcast-and-reduce sweep and the fori_loop sweep are the same
    math with the same first-face-wins tie-breaking."""
    import jax
    import jax.numpy as jnp

    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    o, d = _rays(5000, seed=1)
    if backend == "jax":
        xp = jnp
        scene = jax.tree_util.tree_map(jnp.asarray, scene)
        o, d = (jax.tree_util.tree_map(jnp.asarray, v) for v in (o, d))
    else:
        xp = np
    with np.errstate(all="ignore"):
        t1, f1 = intersect_brute(xp, o, d, scene.tris)
        t2, f2 = intersect_brute_dense(xp, o, d, scene.tris)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))


@pytest.mark.parametrize("leaf", [2, 8, LARGE_SCENE_LEAF])
@pytest.mark.parametrize("backend", ["numpy", "jax"])
def test_bvh_walk_matches_brute(leaf, backend):
    """The whole-batch walk finds the brute sweep's faces bitwise at every
    leaf size the builder uses (the walk unrolls bvh_max_leaf tests per
    step; padding lanes past a leaf's count must never win)."""
    import jax
    import jax.numpy as jnp

    from pbrjax.scene.build import bvh_max_leaf
    from pbrjax.utils.config import BVHConfig

    scene, _ = scene_from_text(
        random_soup(500, seed=3), use_bvh=True, bvh_cfg=BVHConfig(max_faces=leaf)
    )
    ml = bvh_max_leaf(scene)
    o, d = _rays(3000, seed=4)
    xp = np
    if backend == "jax":
        xp = jnp
        scene = jax.tree_util.tree_map(jnp.asarray, scene)
        o, d = (jax.tree_util.tree_map(jnp.asarray, v) for v in (o, d))
    with np.errstate(all="ignore"):
        t1, f1 = intersect_bvh(xp, o, d, scene.bvh, scene.tris, max_leaf=ml)
        t2, f2 = intersect_brute(xp, o, d, scene.tris)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(t1), np.asarray(t2))


@pytest.mark.parametrize(
    "platform,faces,has_bvh,want",
    [
        ("gpu", 34, False, "pallas"),
        ("gpu", 34, True, "pallas"),
        ("gpu", GPU_BRUTE_MAX_FACES, True, "pallas"),
        ("gpu", GPU_BRUTE_MAX_FACES + 1, True, "bvh"),
        ("gpu", 100_000, True, "bvh"),
        ("gpu", 100_000, False, "pallas"),
        ("cpu", 34, False, "brute"),
        ("cpu", 34, True, "bvh"),
        ("cpu", 100_000, True, "bvh"),
    ],
)
def test_select_intersector(platform, faces, has_bvh, want):
    assert select_intersector(platform, faces, has_bvh) == want


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron"])
def test_select_intersector_rejects_other_platforms(platform):
    with pytest.raises(ValueError, match="no intersector for platform"):
        select_intersector(platform, 34, True)


@pytest.mark.parametrize(
    "mode",
    ["gemm", "cull", "sweep", "gated", "pallas_bvh", "pallas_bvh_forest",
     "pallas_bvh_hbm", "dense", "BVH", "nope"],
)
def test_intersect_scene_rejects_unknown_modes(mode):
    """Removed and unknown modes raise instead of falling back to brute."""
    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=True)
    o, d = _rays(8)
    with pytest.raises(ValueError, match="unknown intersector mode"):
        intersect_scene(np, o, d, scene, mode=mode)


def test_auto_dispatch_follows_default_device():
    """The trace's platform is the default device's when one is set (it is
    part of jit's cache key), so one jitted step retraces per device."""
    import jax
    import jax.numpy as jnp

    assert traverse.trace_platform(np) == "cpu"
    assert traverse.trace_platform(jnp) == jax.default_backend()
    with jax.default_device(jax.devices("cpu")[0]):
        assert traverse.trace_platform(jnp) == "cpu"
    with jax.default_device("cpu"):
        assert traverse.trace_platform(jnp) == "cpu"


def test_reeval_t_matches_search_t():
    """intersect_scene re-evaluates the winner differentiably; the re-eval t
    must equal the search t (same face, same formula)."""
    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=True)
    o, d = _rays(20000, seed=7)
    with np.errstate(all="ignore"):
        t_scene, f_scene = intersect_scene(np, o, d, scene)
        t_brute, f_brute = intersect_brute(np, o, d, scene.tris)
    np.testing.assert_array_equal(f_scene, f_brute)
    m = np.isfinite(t_brute)
    np.testing.assert_allclose(t_scene[m], t_brute[m], rtol=1e-6, atol=1e-6)


def test_grads_flow_through_reeval_only():
    """d loss/d origin exists (via re-eval) even on the BVH path, and no
    gradient reaches the triangle arrays (geometry is detached)."""
    import jax
    import jax.numpy as jnp

    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=True)
    jscene = jax.tree_util.tree_map(jnp.asarray, scene)

    def f(oz, trisx):
        o = Vec3(jnp.zeros((16,)), jnp.full((16,), 1.0), jnp.full((16,), oz))
        d = Vec3(jnp.zeros((16,)), jnp.zeros((16,)), jnp.full((16,), -1.0))
        tris = jscene.tris._replace(v0=jscene.tris.v0._replace(x=trisx))
        sc = jscene._replace(tris=tris)
        t, _ = intersect_scene(jnp, o, d, sc)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0))

    g_oz, g_tris = jax.grad(f, argnums=(0, 1))(jnp.float32(3.2), jscene.tris.v0.x)
    assert abs(float(g_oz)) > 0.5  # dt/d eye_z ≈ -1 per hit ray
    assert float(jnp.abs(g_tris).max()) == 0.0  # geometry detached

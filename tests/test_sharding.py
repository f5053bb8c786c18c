"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

Validates the dp (ray-tile) × sp (sample) mesh semantics: sharded renders
equal the unsharded mean-of-frames estimator, and gradient psum produces
the same grads as single-device autodiff (SURVEY.md §7.8).
"""

import functools

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from pbrjax.models.integrator import trace_rays
from pbrjax.parallel.mesh import (
    _shard_seed,
    make_mesh,
    sharded_render,
    sharded_train_step,
)
from util import cornell_scene, to_jax


def _mean_of_frames_unsharded(jnp, scene, cam, settings, frame_seed, n_sp):
    """What the sp axis computes, on one device."""
    import jax

    npx = settings.width * settings.height
    ids = jnp.arange(npx, dtype=jnp.int32)
    acc = None
    for k in range(n_sp):
        seed = _shard_seed(jnp.uint32(frame_seed), jnp.uint32(k))
        res = trace_rays(jnp, scene, cam, settings, ids, seed)
        c = np.stack(
            [np.asarray(res.color.x), np.asarray(res.color.y), np.asarray(res.color.z)], -1
        )
        acc = c if acc is None else acc + c
    return acc / n_sp


def test_mesh_shapes():
    mesh = make_mesh(n_dp=4, n_sp=2)
    assert mesh.shape == {"dp": 4, "sp": 2}


@pytest.mark.parametrize("n_dp,n_sp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_render_matches_unsharded(n_dp, n_sp):
    import jax
    import jax.numpy as jnp

    scene, cam, settings = cornell_scene(use_bvh=False, width=64, height=64)
    jscene, jcam = to_jax(scene), to_jax(cam)
    mesh = make_mesh(n_dp=n_dp, n_sp=n_sp)
    color, focus = sharded_render(mesh, jscene, jcam, settings, frame_seed=5)
    got = np.stack([np.asarray(color.x), np.asarray(color.y), np.asarray(color.z)], -1)
    want = _mean_of_frames_unsharded(jnp, jscene, jcam, settings, 5, n_sp)
    # Same math, different fusion/reduction layout: ULP differences can flip
    # rare discrete path decisions (see test_render_golden.py) — percentile
    # gate, everything else must be float-tight.
    d = np.abs(got - want).max(axis=-1)
    assert (d > 1e-4).mean() < 0.02, f"{(d > 1e-4).mean():.2%} pixels flipped"
    assert np.median(d) < 1e-6


def test_sharded_render_deterministic_across_layouts():
    """The counter-based RNG keys off global pixel id, so dp=8 and dp=2
    must produce the same image (multi-host determinism requirement)."""
    scene, cam, settings = cornell_scene(use_bvh=False, width=32, height=32)
    jscene, jcam = to_jax(scene), to_jax(cam)
    c1, _ = sharded_render(make_mesh(n_dp=8, n_sp=1), jscene, jcam, settings, 3)
    c2, _ = sharded_render(make_mesh(n_dp=2, n_sp=1), jscene, jcam, settings, 3)
    np.testing.assert_allclose(np.asarray(c1.x), np.asarray(c2.x), atol=1e-6)
    np.testing.assert_allclose(np.asarray(c1.z), np.asarray(c2.z), atol=1e-6)


def test_sharded_grads_match_single_device():
    import jax
    import jax.numpy as jnp

    from pbrjax.scene.types import Scene

    scene, cam, settings = cornell_scene(
        use_bvh=False, width=16, height=16, max_depth=2, max_added_depth=0
    )
    jscene, jcam = to_jax(scene), to_jax(cam)
    npx = settings.width * settings.height
    target = np.full((npx, 3), 0.5, dtype=np.float32)

    # single device reference grads
    ids = jnp.arange(npx, dtype=jnp.int32)

    def loss_single(params):
        mats, lights, camst = params
        sc = Scene(tris=jscene.tris, bvh=None, materials=mats, lights=lights)
        seed = _shard_seed(jnp.uint32(9), jnp.uint32(0))
        res = trace_rays(jnp, sc, camst, settings, ids, seed)
        err = (
            (res.color.x - target[:, 0]) ** 2
            + (res.color.y - target[:, 1]) ** 2
            + (res.color.z - target[:, 2]) ** 2
        )
        return jnp.sum(err) / (3.0 * npx)

    params = (jscene.materials, jscene.lights, jcam)
    loss_ref, grads_ref = jax.value_and_grad(loss_single, allow_int=True)(params)

    mesh = make_mesh(n_dp=4, n_sp=1)
    loss_sh, grads_sh, _ = sharded_train_step(
        mesh, jscene, jcam, settings, target, frame_seed=9
    )
    assert abs(float(loss_sh) - float(loss_ref)) < 1e-5

    flat_ref = jax.tree_util.tree_leaves(grads_ref)
    flat_sh = jax.tree_util.tree_leaves(grads_sh)
    assert len(flat_ref) == len(flat_sh)
    checked = 0
    for a, b in zip(flat_ref, flat_sh):
        if a.dtype == jax.dtypes.float0:
            continue
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), rtol=1e-4, atol=1e-5)
        checked += 1
    assert checked > 10  # materials + lights + camera leaves


def test_train_step_over_pixel_partition_sums_to_full_frame():
    """Steps over a partition of the frame (``pixel_ids``) keep the full
    frame's normalization: their losses and grads sum to the full step's."""
    import jax
    import jax.numpy as jnp

    scene, cam, settings = cornell_scene(
        use_bvh=False, width=16, height=16, max_depth=2, max_added_depth=0
    )
    jscene, jcam = to_jax(scene), to_jax(cam)
    npx = settings.width * settings.height
    target = np.full((npx, 3), 0.5, dtype=np.float32)
    mesh = make_mesh(n_dp=2, n_sp=1)
    loss, grads, _ = sharded_train_step(mesh, jscene, jcam, settings, target, 9)
    parts = [
        sharded_train_step(mesh, jscene, jcam, settings, target[sl], 9,
                           pixel_ids=jnp.arange(npx, dtype=jnp.int32)[sl])
        for sl in (slice(0, npx // 4), slice(npx // 4, npx))
    ]
    np.testing.assert_allclose(sum(float(p[0]) for p in parts), float(loss), rtol=1e-5)
    leaves = [jax.tree_util.tree_leaves(g) for g in (grads, parts[0][1], parts[1][1])]
    checked = 0
    for g, a, b in zip(*leaves):
        if g.dtype == jax.dtypes.float0:
            continue
        np.testing.assert_allclose(np.asarray(a) + np.asarray(b), np.asarray(g),
                                   rtol=1e-4, atol=1e-5)
        checked += 1
    assert checked > 10


def test_sgd_step_reduces_loss():
    import jax

    scene, cam, settings = cornell_scene(
        use_bvh=False, width=16, height=16, max_depth=2, max_added_depth=0
    )
    jscene, jcam = to_jax(scene), to_jax(cam)
    npx = settings.width * settings.height
    target = np.zeros((npx, 3), dtype=np.float32)
    mesh = make_mesh(n_dp=4, n_sp=2)
    from pbrjax.scene.types import Scene

    loss0, grads, params = sharded_train_step(
        mesh, jscene, jcam, settings, target, frame_seed=1, lr=0.05
    )
    mats, lights, camst = params
    scene1 = Scene(tris=jscene.tris, bvh=None, materials=mats, lights=lights)
    loss1, _, _ = sharded_train_step(
        mesh, scene1, camst, settings, target, frame_seed=1, lr=0.0
    )
    assert float(loss1) < float(loss0)

"""The fused intersect kernel compiled for the card (no interpret mode).

Skips without a GPU. On a GPU host:
``PBRJAX_TEST_GPU=1 python -m pytest -m gpu tests/``.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _cornell():
    import jax
    import jax.numpy as jnp

    from pbrjax.scene.build import scene_from_text
    from pbrjax.scene.procedural import cornell_box

    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    return jax.tree_util.tree_map(jnp.asarray, scene)


def test_kernel_matches_brute_on_gpu(gpu):
    """Same face on >= 99.99% of rays; t within 1e-5 relative where the
    faces agree (FMA contraction may differ between the two compilers)."""
    import jax
    import jax.numpy as jnp

    from pbrjax.ops.pallas_intersect import intersect_pallas
    from pbrjax.ops.traverse import intersect_brute
    from pbrjax.ops.vec import Vec3

    js = _cornell()
    rng = np.random.default_rng(0)
    n = 1 << 18
    o = Vec3(*[jnp.asarray(rng.uniform(-0.8, 0.8, n), jnp.float32) for _ in range(3)])
    dn = rng.normal(size=(3, n)).astype(np.float32)
    dn /= np.linalg.norm(dn, axis=0, keepdims=True)
    d = Vec3(*[jnp.asarray(c) for c in dn])
    t_k, f_k = jax.jit(lambda o, d: intersect_pallas(jnp, o, d, js.tris))(o, d)
    t_b, f_b = jax.jit(lambda o, d: intersect_brute(jnp, o, d, js.tris))(o, d)
    f_k, f_b, t_k, t_b = (np.asarray(a) for a in (f_k, f_b, t_k, t_b))
    same = f_k == f_b
    assert same.mean() >= 0.9999
    hit = same & (f_b >= 0)
    np.testing.assert_allclose(t_k[hit], t_b[hit], rtol=1e-5)


def test_auto_dispatch_runs_kernel_on_gpu(gpu):
    """A Cornell-sized scene auto-dispatches the kernel on the GPU and the
    trace matches the plain sweep's image to the golden gate."""
    import jax
    import jax.numpy as jnp

    from pbrjax.models.integrator import trace_rays
    from pbrjax.ops.traverse import select_intersector
    from pbrjax.scene.camera import make_camera_state
    from pbrjax.utils.config import RenderSettings

    js = _cornell()
    assert select_intersector(gpu.platform, js.tris.count, False) == "pallas"
    cam = jax.tree_util.tree_map(
        jnp.asarray, make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    )
    base = RenderSettings(width=64, height=64, shadow_rays=1, sky_light=(0.85, 0.9, 1.0))
    ids = jnp.arange(64 * 64, dtype=jnp.int32)
    imgs = []
    for mode in ("auto", "brute"):
        s = base.replace(intersector=mode)
        c = jax.jit(lambda sc, cm: trace_rays(jnp, sc, cm, s, ids, jnp.uint32(1)).color)(js, cam)
        imgs.append(np.stack([np.asarray(c.x), np.asarray(c.y), np.asarray(c.z)], -1))
    d = np.abs(imgs[0] - imgs[1]).max(axis=-1)
    assert (d > 1e-3).mean() <= 0.01

"""Differentiable-pass tests: AD gradients vs central finite differences
(SURVEY.md §7.7; BASELINE.json config 4 — material/light/camera gradients).

Detached-sampling semantics: RNG uniforms are hash constants, so for a
fixed seed the rendered image is a piecewise-smooth function of materials,
lights, and camera; AD follows the smooth piece. Finite differences with
small epsilon stay on the same piece for almost all pixels.
"""

import functools

import numpy as np
import pytest

pytestmark = pytest.mark.slow

from pbrjax.models.integrator import trace_rays
from pbrjax.scene.types import Scene
from util import cornell_scene, to_jax


def _loss_builder(settings):
    import jax
    import jax.numpy as jnp

    npx = settings.width * settings.height
    ids = np.arange(npx, dtype=np.int32)

    @functools.partial(jax.jit, static_argnames=("settings",))
    def loss(mats, lights, cam, tris, settings):
        sc = Scene(tris=tris, bvh=None, materials=mats, lights=lights)
        res = trace_rays(jnp, sc, cam, settings, jnp.asarray(ids), jnp.uint32(13))
        return (
            jnp.sum(res.color.x**2) + jnp.sum(res.color.y**2) + jnp.sum(res.color.z**2)
        ) / npx

    return loss


@pytest.fixture(scope="module")
def setup():
    scene, cam, settings = cornell_scene(
        use_bvh=False, width=16, height=16, max_depth=3, max_added_depth=0,
        anti_aliasing=0.3,
    )
    jscene, jcam = to_jax(scene), to_jax(cam)
    loss = _loss_builder(settings)
    return jscene, jcam, settings, loss


def _fd_check(f, x0, grad_ad, eps, atol, rtol, n_checks=4):
    """Central finite differences on a few coordinates."""
    ok = 0
    for i in range(min(n_checks, x0.size)):
        d = np.zeros_like(np.asarray(x0))
        d.flat[i] = eps
        fp = float(f(np.asarray(x0) + d))
        fm = float(f(np.asarray(x0) - d))
        fd = (fp - fm) / (2 * eps)
        ad = float(np.asarray(grad_ad).flat[i])
        assert abs(fd - ad) <= atol + rtol * abs(fd), (i, fd, ad)
        ok += 1
    assert ok > 0


def test_material_kd_grads(setup):
    import jax

    jscene, jcam, settings, loss = setup

    def f_of_kdx(kdx):
        mats = jscene.materials._replace(
            kd=jscene.materials.kd._replace(x=jax.numpy.asarray(kdx, dtype=np.float32))
        )
        return loss(mats, jscene.lights, jcam, jscene.tris, settings)

    g = jax.grad(
        lambda kdx: f_of_kdx(kdx)
    )(jscene.materials.kd.x)
    assert not np.isnan(np.asarray(g)).any()
    assert np.abs(np.asarray(g)).max() > 1e-4  # materials visibly matter
    _fd_check(f_of_kdx, jscene.materials.kd.x, g, eps=1e-3, atol=5e-3, rtol=5e-2)


def test_light_rgb_grads(setup):
    import jax

    jscene, jcam, settings, loss = setup

    def f(rgbx):
        lights = jscene.lights._replace(
            rgb=jscene.lights.rgb._replace(x=jax.numpy.asarray(rgbx, dtype=np.float32))
        )
        return loss(jscene.materials, lights, jcam, jscene.tris, settings)

    g = jax.grad(f)(jscene.lights.rgb.x)
    assert not np.isnan(np.asarray(g)).any()
    assert np.abs(np.asarray(g)).max() > 1e-4  # NEE makes light color matter
    _fd_check(f, jscene.lights.rgb.x, g, eps=1e-2, atol=5e-3, rtol=5e-2, n_checks=1)


def test_camera_eye_grads():
    """Camera gradients are *interior* gradients (detached sampling — no
    silhouette/visibility term, by design). Verified on a configuration
    where the image depends on the eye only through smooth terms: one
    triangle + unoccluded orb light + NEE — the hit point (and hence the
    shadow-ray geometry) moves smoothly with the eye."""
    import functools

    import jax
    import jax.numpy as jnp

    from pbrjax.scene.build import scene_from_text
    from pbrjax.scene.camera import make_camera_state
    from pbrjax.scene.procedural import single_triangle
    from pbrjax.utils.config import RenderSettings

    obj, mtl, _ = single_triangle()
    lights = "newlight l\ntype 2\npos 0.5 2.0 1.0\nradius 0.05\nrgb 3 3 3\n"
    scene, _ = scene_from_text(obj, mtl, lights, use_bvh=False)
    jscene = to_jax(scene)
    cam0 = make_camera_state(eye=(0.0, 0.5, 2.0), center_dir=(0.0, 0.0, 1.0))
    jcam = to_jax(cam0)
    # Schlick BRDF: the S-A path's maxRGB normalization cancels scalar
    # weights for diffuse materials (pathtracing.cl:149-152 — a faithful
    # reference quirk), which would zero the eye dependence entirely.
    settings = RenderSettings(
        width=16, height=16, samples=1, max_depth=2, max_added_depth=0,
        shadow_rays=1, anti_aliasing=0.0, brdf=0,
    )
    npx = settings.width * settings.height
    ids = jnp.arange(npx, dtype=jnp.int32)

    @functools.partial(jax.jit, static_argnames=("settings",))
    def loss(eye_z, settings):
        cam = jcam._replace(eye=jcam.eye._replace(z=eye_z))
        res = trace_rays(jnp, jscene, cam, settings, ids, jnp.uint32(13))
        return (
            jnp.sum(res.color.x**2) + jnp.sum(res.color.y**2) + jnp.sum(res.color.z**2)
        ) / npx

    z0 = float(np.asarray(jcam.eye.z))
    f = lambda z: float(loss(jnp.asarray(z, dtype=np.float32), settings))  # noqa: E731
    g = float(jax.grad(lambda z: loss(z, settings))(jnp.float32(z0)))
    assert np.isfinite(g) and abs(g) > 1e-6
    eps = 1e-3
    fd = (f(z0 + eps) - f(z0 - eps)) / (2 * eps)
    assert abs(fd - g) <= 1e-3 + 0.05 * abs(fd), (fd, g)


def test_light_pos_grads(setup):
    import jax

    jscene, jcam, settings, loss = setup

    def f(posy):
        lights = jscene.lights._replace(
            pos=jscene.lights.pos._replace(y=jax.numpy.asarray(posy, dtype=np.float32))
        )
        return loss(jscene.materials, lights, jcam, jscene.tris, settings)

    g = jax.grad(f)(jscene.lights.pos.y)
    assert np.isfinite(np.asarray(g)).all()


def test_inverse_rendering_recovers_albedo():
    """Mini inverse-rendering fit: perturb the white wall's red channel,
    recover it by gradient descent against the original image."""
    import jax
    import jax.numpy as jnp

    scene, cam, settings = cornell_scene(
        use_bvh=False, width=16, height=16, max_depth=2, max_added_depth=0,
        shadow_rays=1, brdf=0,
    )
    jscene, jcam = to_jax(scene), to_jax(cam)
    npx = settings.width * settings.height
    ids = jnp.arange(npx, dtype=jnp.int32)

    def render(kdx):
        mats = jscene.materials._replace(
            kd=jscene.materials.kd._replace(x=kdx)
        )
        sc = Scene(tris=jscene.tris, bvh=None, materials=mats, lights=jscene.lights)
        res = trace_rays(jnp, sc, jcam, settings, ids, jnp.uint32(21))
        return res.color

    true_kdx = jscene.materials.kd.x
    target = render(true_kdx)

    @jax.jit
    def step(kdx, lr):
        def loss_fn(kdx):
            c = render(kdx)
            return (
                jnp.sum((c.x - target.x) ** 2)
                + jnp.sum((c.y - target.y) ** 2)
                + jnp.sum((c.z - target.z) ** 2)
            ) / npx

        l, g = jax.value_and_grad(loss_fn)(kdx)
        # Optimize only the perturbed coordinate (others start at truth;
        # a bare SGD step on all coords can fling glossy materials into
        # flat clamped regions — an optimizer concern, not an AD one).
        g = g * jnp.zeros_like(g).at[0].set(1.0)
        return l, kdx - lr * g

    kdx = true_kdx.at[0].set(0.2)  # perturb material 0 ('white') red channel
    l0, _ = step(kdx, 0.0)
    for _ in range(120):
        l, kdx = step(kdx, 0.01)
    assert float(l) < float(l0) * 0.05, (float(l0), float(l))
    assert abs(float(kdx[0]) - float(true_kdx[0])) < 0.05

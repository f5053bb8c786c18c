"""Golden tests: jax-path renderer vs the CPU oracle tracer.

Gate semantics (documented, deliberate): XLA fuses FMAs and uses its own
libm, so float results differ from NumPy by ULPs; a path tracer is chaotic,
so a ULP can flip a rare discrete decision (hit/miss at a triangle edge,
RR, sampler quadrant). The contract is therefore percentile-based: ≥ 99% of
pixels agree to 1e-3 and the mean error is tiny; a handful of flipped
pixels are allowed and expected.
"""

import functools

import numpy as np
import pytest

from pbrjax.models.integrator import trace_rays
from pbrjax.reference.cpu import render_cpu
from util import cornell_scene, to_jax, tri_scene


def _render_jax(scene, cam, settings, seed):
    import jax
    import jax.numpy as jnp

    jscene, jcam = to_jax(scene), to_jax(cam)
    ids = jnp.arange(settings.width * settings.height, dtype=jnp.int32)
    f = jax.jit(functools.partial(trace_rays, jnp), static_argnames=("settings",))
    res = f(jscene, jcam, settings=settings, pixel_ids=ids, frame_seed=jnp.uint32(seed))
    rgb = np.stack(
        [np.asarray(res.color.x), np.asarray(res.color.y), np.asarray(res.color.z)], -1
    )
    return rgb.reshape(settings.height, settings.width, 3), np.asarray(res.focus_t)


def _assert_close(rgb_j, rgb_np, flip_budget=0.01, mean_tol=1e-2):
    d = np.abs(rgb_j - rgb_np).max(axis=-1)
    flips = (d > 1e-3).mean()
    assert flips <= flip_budget, f"{flips:.2%} pixels flipped (> {flip_budget:.0%})"
    agree = d <= 1e-3
    assert d[agree].max() <= 1e-3
    assert np.abs(rgb_j - rgb_np)[agree].mean() < mean_tol


def test_single_triangle_matches_oracle():
    scene, cam, settings = tri_scene()
    rgb_np, _ = render_cpu(scene, cam, settings, frame_seed=7)
    rgb_j, _ = _render_jax(scene, cam, settings, 7)
    assert not np.isnan(rgb_j).any()
    _assert_close(rgb_j, rgb_np, flip_budget=0.005)


def test_cornell_matches_oracle_sa():
    scene, cam, settings = cornell_scene(use_bvh=True)
    rgb_np, _ = render_cpu(scene, cam, settings, frame_seed=3)
    rgb_j, _ = _render_jax(scene, cam, settings, 3)
    assert not np.isnan(rgb_j).any()
    _assert_close(rgb_j, rgb_np)


def test_cornell_matches_oracle_schlick():
    scene, cam, settings = cornell_scene(use_bvh=True, brdf=0)
    rgb_np, _ = render_cpu(scene, cam, settings, frame_seed=11)
    rgb_j, _ = _render_jax(scene, cam, settings, 11)
    assert not np.isnan(rgb_j).any()
    _assert_close(rgb_j, rgb_np)


def test_bvh_equals_brute_force_render():
    """Exact (bitwise) equality on the same backend: swapping the
    acceleration structure must not change the image at all."""
    from pbrjax.scene.types import Scene

    scene, cam, settings = cornell_scene(use_bvh=True)
    scene_nb = Scene(tris=scene.tris, bvh=None, materials=scene.materials, lights=scene.lights)
    r1, _ = render_cpu(scene, cam, settings, frame_seed=1)
    r2, _ = render_cpu(scene_nb, cam, settings, frame_seed=1)
    np.testing.assert_array_equal(r1, r2)


def test_seed_changes_image():
    scene, cam, settings = cornell_scene(use_bvh=True)
    r1, _ = render_cpu(scene, cam, settings, frame_seed=1)
    r2, _ = render_cpu(scene, cam, settings, frame_seed=2)
    assert np.abs(r1 - r2).max() > 1e-3


def test_progressive_accumulation_reduces_noise():
    """Progressive n/(n+1) blending must converge: variance between two
    16-frame accumulations is far below single-frame variance."""
    import jax.numpy as jnp

    from pbrjax.models.pathtracer import FrameState, init_frame_state, render_frame

    scene, cam, settings = cornell_scene(use_bvh=True, width=32, height=32)
    npx = settings.width * settings.height
    ids = np.arange(npx, dtype=np.int32)

    def accumulate(seed0, frames):
        state = init_frame_state(np, npx)
        for i in range(frames):
            state = render_frame(np, scene, cam, settings, state, ids, seed0 + i)
        return np.stack([state.rgb.x, state.rgb.y, state.rgb.z], -1)

    one_a = accumulate(100, 1)
    one_b = accumulate(200, 1)
    many_a = accumulate(100, 16)
    many_b = accumulate(200, 16)
    var1 = np.mean((one_a - one_b) ** 2)
    var16 = np.mean((many_a - many_b) ** 2)
    assert var16 < var1 / 4


def test_sky_and_nee_light():
    # Rays that miss all geometry show the sky color (pathtracing.cl:263-266).
    scene, cam, settings = tri_scene()
    settings = settings.replace(sky_light=(0.2, 0.4, 0.6))
    rgb, _ = render_cpu(scene, cam, settings, frame_seed=0)
    np.testing.assert_allclose(rgb[0, 0], (0.2, 0.4, 0.6), atol=1e-5)

    # NEE (shadow rays to lights[0], pathtracing.cl:284-290) must add energy
    # vs. the same render without it.
    scene, cam, settings = cornell_scene(use_bvh=True)
    with_nee, _ = render_cpu(scene, cam, settings, frame_seed=5)
    without_nee, _ = render_cpu(scene, cam, settings.replace(shadow_rays=0), frame_seed=5)
    assert with_nee.mean() > without_nee.mean() + 0.05


def test_focus_channel_is_first_hit_distance():
    scene, cam, settings = tri_scene()
    _, focus = render_cpu(scene, cam, settings, frame_seed=0)
    c = focus[32, 32]
    assert 2.9 < c < 3.1  # eye at z=2, triangle at z=-1

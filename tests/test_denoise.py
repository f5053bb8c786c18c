"""Noise filter (the completed noise_filtering.cl capability).

The reference's denoiser was unfinished dead code; ours must actually work:
(1) it reduces Monte-Carlo noise on a real render, (2) it preserves feature
edges (the whole point of RPF-style filtering vs a plain blur), and (3) the
numpy and jax paths agree.
"""

import numpy as np
import pytest

from pbrjax.ops.denoise import denoise_render, first_hit_features, noise_filter


def _synthetic():
    """Two flat regions split by a normal+depth edge, plus noise."""
    rs = np.random.RandomState(7)
    h = w = 64
    clean = np.zeros((h, w, 3), np.float32)
    clean[:, : w // 2] = (0.8, 0.2, 0.2)
    clean[:, w // 2 :] = (0.1, 0.1, 0.9)
    noisy = clean + rs.normal(0.0, 0.15, clean.shape).astype(np.float32)
    normal = np.zeros((h, w, 3), np.float32)
    normal[:, : w // 2, 2] = 1.0
    normal[:, w // 2 :, 0] = 1.0
    depth = np.ones((h, w), np.float32)
    depth[:, w // 2 :] = 3.0
    return clean, noisy, normal, depth


def test_filter_reduces_noise_and_keeps_edges_numpy():
    clean, noisy, normal, depth = _synthetic()
    out = noise_filter(np, noisy, normal, depth, iterations=3)
    mse_in = float(np.mean((noisy - clean) ** 2))
    mse_out = float(np.mean((out - clean) ** 2))
    assert mse_out < 0.25 * mse_in, (mse_in, mse_out)
    # The feature edge must survive: cross-edge contrast stays >= 80%.
    mid = clean.shape[1] // 2
    contrast = np.abs(
        out[:, mid - 2].mean(axis=0) - out[:, mid + 1].mean(axis=0)
    ).sum()
    contrast_clean = np.abs(
        clean[:, mid - 2].mean(axis=0) - clean[:, mid + 1].mean(axis=0)
    ).sum()
    assert contrast > 0.8 * contrast_clean


def test_filter_jax_matches_numpy():
    import jax
    import jax.numpy as jnp

    clean, noisy, normal, depth = _synthetic()
    out_np = noise_filter(np, noisy, normal, depth, iterations=2)
    f = jax.jit(lambda c, n, z: noise_filter(jnp, c, n, z, iterations=2))
    out_j = np.asarray(f(noisy, normal, depth))
    np.testing.assert_allclose(out_np, out_j, rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def cornell_small():
    from pbrjax.scene.build import scene_from_text
    from pbrjax.scene.camera import make_camera_state
    from pbrjax.scene.procedural import cornell_box
    from pbrjax.utils.config import RenderSettings

    obj, mtl, li = cornell_box()
    scene, _ = scene_from_text(obj, mtl, li, use_bvh=False)
    cam = make_camera_state(eye=(0.0, 1.0, 3.2), center_dir=(0.0, 0.0, 1.0))
    settings = RenderSettings(
        width=48, height=48, samples=1, max_depth=3, max_added_depth=1,
        shadow_rays=1, sky_light=(0.9, 0.9, 1.0),
    )
    return scene, cam, settings


def test_first_hit_features_finite(cornell_small):
    scene, cam, settings = cornell_small
    normal, depth, albedo = first_hit_features(np, scene, cam, settings)
    assert normal.shape == (48, 48, 3)
    assert depth.shape == (48, 48)
    assert albedo.shape == (48, 48, 3)
    assert np.isfinite(normal).all() and np.isfinite(depth).all()
    assert np.isfinite(albedo).all()
    # Center rays hit the box interior: unit normals there.
    lens = np.linalg.norm(normal[20:28, 20:28], axis=-1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-5)


def test_denoise_real_render_improves_mse(cornell_small):
    from pbrjax.models.integrator import trace_rays

    scene, cam, settings = cornell_small
    w, h = settings.width, settings.height
    ids = np.arange(w * h, dtype=np.int32)

    def frame_avg(n_frames):
        acc = np.zeros((w * h, 3), np.float32)
        for s in range(n_frames):
            res = trace_rays(np, scene, cam, settings, ids, np.uint32(s))
            acc += np.stack([res.color.x, res.color.y, res.color.z], axis=-1)
        return (acc / n_frames).reshape(h, w, 3)

    noisy = frame_avg(1)
    ref = frame_avg(24)
    den = denoise_render(np, noisy, scene, cam, settings)
    mse_noisy = float(np.mean((noisy - ref) ** 2))
    mse_den = float(np.mean((den - ref) ** 2))
    assert mse_den < 0.6 * mse_noisy, (mse_noisy, mse_den)

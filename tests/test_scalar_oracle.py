"""Independent-oracle tests: scalar tracer ≡ numpy integrator ≡ jax integrator.

``pbrjax.reference.scalar`` is a straight-line per-pixel tracer sharing no
code with ``models/integrator.py`` (its own vec math, BRDFs, RNG hash, and
the reference's *dynamic* control flow instead of wavefront masks). Agreement
here is evidence the integrator's logic is right, not merely that two
backends of the same code agree. 8×8 crops keep the scalar path fast.

Gate: the implementations share semantics but not op order, so results agree
to float32 noise (measured max ~8e-6), not bitwise; the gate is 1e-3 per
pixel with a tiny mean.
"""

import numpy as np
import pytest

from pbrjax.models.integrator import trace_rays
from pbrjax.reference.scalar import _uniform, render_scalar
from util import cornell_scene, to_jax, tri_scene


def _crop_ids(settings, n=8):
    w, h = settings.width, settings.height
    ys, xs = np.meshgrid(
        np.arange(h // 2 - n // 2, h // 2 + n // 2),
        np.arange(w // 2 - n // 2, w // 2 + n // 2),
        indexing="ij",
    )
    return (ys * w + xs).reshape(-1).astype(np.int32)


def _integrator_rgb(xp, scene, cam, settings, ids, seed):
    if xp is np:
        res = trace_rays(np, scene, cam, settings, ids, seed)
        return np.stack([res.color.x, res.color.y, res.color.z], -1)
    import functools

    import jax
    import jax.numpy as jnp

    f = jax.jit(functools.partial(trace_rays, jnp), static_argnames=("settings",))
    res = f(
        to_jax(scene), to_jax(cam), settings=settings,
        pixel_ids=jnp.asarray(ids), frame_seed=jnp.uint32(seed),
    )
    return np.stack(
        [np.asarray(res.color.x), np.asarray(res.color.y), np.asarray(res.color.z)], -1
    )


CASES = [
    ("tri", lambda: tri_scene(), 7),
    ("cornell-sa", lambda: cornell_scene(use_bvh=False, width=16, height=16), 3),
    (
        "cornell-schlick",
        lambda: cornell_scene(use_bvh=False, width=16, height=16, brdf=0),
        11,
    ),
]


@pytest.mark.parametrize("name,make,seed", CASES, ids=[c[0] for c in CASES])
def test_scalar_matches_numpy_integrator(name, make, seed):
    scene, cam, settings = make()
    ids = _crop_ids(settings)
    rgb_int = _integrator_rgb(np, scene, cam, settings, ids, seed)
    rgb_sc, foc = render_scalar(scene, cam, settings, frame_seed=seed, pixel_ids=ids)
    assert np.isfinite(rgb_sc).all()
    d = np.abs(rgb_int - rgb_sc).max(axis=-1)
    assert (d > 1e-3).sum() == 0, f"max diff {d.max():.3e}"
    assert np.abs(rgb_int - rgb_sc).mean() < 1e-4


@pytest.mark.parametrize("name,make,seed", CASES[1:2], ids=["cornell-sa"])
def test_scalar_matches_jax_integrator(name, make, seed):
    scene, cam, settings = make()
    ids = _crop_ids(settings)
    rgb_j = _integrator_rgb(None, scene, cam, settings, ids, seed)
    rgb_sc, _ = render_scalar(scene, cam, settings, frame_seed=seed, pixel_ids=ids)
    d = np.abs(rgb_j - rgb_sc).max(axis=-1)
    # XLA fusion/libm adds ULP noise on top of op-order noise; allow one
    # chaotic flip in the 64-pixel crop (same budget as the golden tests).
    assert (d > 1e-3).sum() <= 1, f"max diff {d.max():.3e}"


def test_scalar_rng_matches_rng_module():
    """The inline pure-Python hash must reproduce ops/rng.py exactly —
    an independent check of the RNG's uint32 arithmetic."""
    from pbrjax.ops import rng as rng_mod

    rs = np.random.RandomState(0)
    for _ in range(50):
        seed = int(rs.randint(0, 2**32, dtype=np.uint64))
        pid = int(rs.randint(0, 2**31))
        s, b, st = int(rs.randint(0, 16)), int(rs.randint(0, 8)), int(rs.randint(0, 11))
        a = rng_mod.uniform(np.uint32(seed), np.uint32(pid), s, b, st)
        b_ = _uniform(seed, pid, s, b, st)
        assert np.float32(a) == b_


def test_scalar_focus_channel():
    """focus_t = sample-0 first-hit distance (pt_rgb.cl:18) — finite where
    the crop sees geometry."""
    scene, cam, settings = cornell_scene(use_bvh=False, width=16, height=16)
    ids = _crop_ids(settings)
    res = trace_rays(np, scene, cam, settings, ids, 3)
    _, foc = render_scalar(scene, cam, settings, frame_seed=3, pixel_ids=ids)
    both_finite = np.isfinite(res.focus_t) & np.isfinite(foc)
    assert both_finite.any()
    np.testing.assert_allclose(
        foc[both_finite], res.focus_t[both_finite], rtol=1e-5, atol=1e-5
    )
    assert (np.isfinite(res.focus_t) == np.isfinite(foc)).mean() > 0.98

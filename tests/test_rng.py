"""Counter-based RNG: determinism, uniformity, backend equality."""

import numpy as np

from pbrjax.ops import rng as R


def test_deterministic():
    ids = np.arange(128, dtype=np.uint32)
    a = R.uniform(7, ids, 0, 1, R.S_RR)
    b = R.uniform(7, ids, 0, 1, R.S_RR)
    assert np.array_equal(a, b)


def test_stream_separation():
    ids = np.arange(1024, dtype=np.uint32)
    a = R.uniform(7, ids, 0, 1, R.S_RR)
    b = R.uniform(7, ids, 0, 1, R.S_TRANS)
    c = R.uniform(7, ids, 0, 2, R.S_RR)
    d = R.uniform(8, ids, 0, 1, R.S_RR)
    assert not np.array_equal(a, b)
    assert not np.array_equal(a, c)
    assert not np.array_equal(a, d)


def test_range_and_uniformity():
    ids = np.arange(1 << 16, dtype=np.uint32)
    u = R.uniform(3, ids, 0, 0, R.S_BRDF_A)
    assert u.dtype == np.float32
    assert (u >= 0.0).all() and (u < 1.0).all()
    assert abs(float(u.mean()) - 0.5) < 5e-3
    hist, _ = np.histogram(u, bins=16, range=(0, 1))
    assert hist.min() > 0.8 * (len(ids) / 16)


def test_pixel_decorrelation():
    """Adjacent pixels must not correlate (the reference's fract-sin RNG
    visibly did, pt_utils.cl:39-44 — this is the capability upgrade)."""
    ids = np.arange(1 << 14, dtype=np.uint32)
    u = R.uniform(3, ids, 0, 0, R.S_RR).astype(np.float64)
    corr = np.corrcoef(u[:-1], u[1:])[0, 1]
    assert abs(corr) < 0.02


def test_numpy_jax_bitwise_equal():
    import jax.numpy as jnp

    ids = np.arange(4096, dtype=np.uint32)
    a = R.PixelRng(9, ids).u(1, 2, R.S_BRDF_B)
    b = np.asarray(R.PixelRng(jnp.uint32(9), jnp.asarray(ids)).u(1, 2, R.S_BRDF_B))
    assert np.array_equal(a, b)

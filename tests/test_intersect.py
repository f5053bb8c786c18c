"""Unit tests for primitive intersectors (Möller-Trumbore, slab, sphere)."""

import numpy as np

from pbrjax.ops.intersect import moller_trumbore, slab_box, sphere
from pbrjax.ops.vec import Vec3


def v3(x, y, z):
    return Vec3(np.float32(x), np.float32(y), np.float32(z))


def test_mt_basic_hit():
    o = v3(0.25, 0.25, 1.0)
    d = v3(0.0, 0.0, -1.0)
    t, valid = moller_trumbore(np, o, d, v3(0, 0, 0), v3(1, 0, 0), v3(0, 1, 0))
    assert valid and abs(t - 1.0) < 1e-6


def test_mt_miss_outside():
    o = v3(0.9, 0.9, 1.0)  # u+v > 1
    d = v3(0.0, 0.0, -1.0)
    _, valid = moller_trumbore(np, o, d, v3(0, 0, 0), v3(1, 0, 0), v3(0, 1, 0))
    assert not valid


def test_mt_behind_and_epsilon():
    o = v3(0.25, 0.25, -1.0)
    d = v3(0.0, 0.0, -1.0)
    _, valid = moller_trumbore(np, o, d, v3(0, 0, 0), v3(1, 0, 0), v3(0, 1, 0))
    assert not valid  # triangle behind the ray
    o2 = v3(0.25, 0.25, 5e-6)
    d2 = v3(0.0, 0.0, -1.0)
    _, valid2 = moller_trumbore(np, o2, d2, v3(0, 0, 0), v3(1, 0, 0), v3(0, 1, 0))
    assert not valid2  # within EPSILON5 (pt_intersect.cl:107)


def test_mt_parallel():
    o = v3(0.0, 0.0, 1.0)
    d = v3(1.0, 0.0, 0.0)
    with np.errstate(all="ignore"):
        _, valid = moller_trumbore(np, o, d, v3(0, 0, 0), v3(1, 0, 0), v3(0, 1, 0))
    assert not valid


def test_slab_hit_miss():
    inv = v3(1.0, 1e30, 1e30)  # dir ~ +x
    tn, tf, hit = slab_box(np, v3(-2, 0.5, 0.5), inv, v3(0, 0, 0), v3(1, 1, 1))
    assert hit and abs(tn - 2.0) < 1e-5
    tn, tf, hit = slab_box(np, v3(-2, 2.5, 0.5), inv, v3(0, 0, 0), v3(1, 1, 1))
    assert not hit


def test_slab_boundary_parallel_is_hit():
    """Ray lying exactly in a box face plane must not be dropped (the
    0 * inf = NaN case; conservative policy)."""
    with np.errstate(all="ignore"):
        inv = Vec3(np.float32(1.0), np.float32(np.inf), np.float32(np.inf))  # dir = +x
        tn, tf, hit = slab_box(np, v3(-2, 0.0, 0.5), inv, v3(0, 0, 0), v3(1, 1, 1))
    assert hit and abs(tn - 2.0) < 1e-5


def test_sphere_radius_squared_semantics():
    """The reference compares d² against the raw radius parameter
    (pt_intersect.cl:51-57) — it behaves as radius²; we preserve that."""
    o = v3(0.0, 0.0, 5.0)
    d = v3(0.0, 0.0, -1.0)
    t, hit = sphere(np, o, d, v3(0, 0, 0), np.float32(4.0))  # r_sq=4 → radius 2
    assert hit and abs(t - 3.0) < 1e-5
    o2 = v3(1.5, 0.0, 5.0)
    _, hit2 = sphere(np, o2, d, v3(0, 0, 0), np.float32(4.0))
    assert hit2  # 1.5 < 2
    o3 = v3(2.5, 0.0, 5.0)
    _, hit3 = sphere(np, o3, d, v3(0, 0, 0), np.float32(4.0))
    assert not hit3


def test_sphere_behind():
    o = v3(0.0, 0.0, -5.0)
    d = v3(0.0, 0.0, -1.0)
    _, hit = sphere(np, o, d, v3(0, 0, 0), np.float32(1.0))
    assert not hit

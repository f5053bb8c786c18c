"""Native (C++) BVH builder ≡ NumPy builder, byte for byte."""

import os

import numpy as np
import pytest

from pbrjax.accel.bvh import build_bvh
from pbrjax.accel.native import available, build_bvh_native
from pbrjax.scene.build import scene_from_text
from pbrjax.scene.procedural import cornell_box, random_soup
from pbrjax.utils.config import BVHConfig

pytestmark = pytest.mark.skipif(not available(), reason="native builder unavailable")


def _tri_arrays(obj_text, mtl="", lights=""):
    scene, _ = scene_from_text(obj_text, mtl, lights, use_bvh=False)
    v0 = scene.tris.v0.stack(np)
    v1 = (scene.tris.v0 + scene.tris.e1).stack(np)
    v2 = (scene.tris.v0 + scene.tris.e2).stack(np)
    return v0, v1, v2


def _assert_equal(cfg, v0, v1, v2):
    lin_py, order_py, _ = build_bvh(v0, v1, v2, cfg)
    lin_c, order_c = build_bvh_native(v0, v1, v2, cfg)
    np.testing.assert_array_equal(order_c, order_py)
    np.testing.assert_array_equal(np.asarray(lin_c.exit), np.asarray(lin_py.exit))
    np.testing.assert_array_equal(np.asarray(lin_c.leaf_first), np.asarray(lin_py.leaf_first))
    np.testing.assert_array_equal(np.asarray(lin_c.leaf_count), np.asarray(lin_py.leaf_count))
    np.testing.assert_array_equal(lin_c.bb_min.stack(np), lin_py.bb_min.stack(np))
    np.testing.assert_array_equal(lin_c.bb_max.stack(np), lin_py.bb_max.stack(np))


def test_cornell_exact():
    obj, mtl, li = cornell_box()
    _assert_equal(BVHConfig(max_faces=2), *_tri_arrays(obj, mtl, li))


def test_soup_exact_sah():
    _assert_equal(BVHConfig(max_faces=2), *_tri_arrays(random_soup(777, seed=2)))


def test_soup_exact_mean_split():
    _assert_equal(
        BVHConfig(max_faces=4, sah_faces_limit=64), *_tri_arrays(random_soup(900, seed=5))
    )


def test_native_is_faster_on_large():
    import time

    v0, v1, v2 = _tri_arrays(random_soup(20000, seed=7))
    t0 = time.perf_counter()
    build_bvh(v0, v1, v2, BVHConfig())
    t_py = time.perf_counter() - t0
    t0 = time.perf_counter()
    build_bvh_native(v0, v1, v2, BVHConfig())
    t_c = time.perf_counter() - t0
    # Not a strict perf gate on CI noise — just sanity that native wins big.
    assert t_c < t_py, (t_c, t_py)


def test_soup_exact_skip_ahead():
    _assert_equal(
        BVHConfig(max_faces=2, skip_ahead=True),
        *_tri_arrays(random_soup(777, seed=2)),
    )


def test_native_builder_leak_check(tmp_path):
    """ASan leak/memory check of the native builder — the counterpart of the
    reference's valgrind harness (valgrind/valgrind.sh). Builds csrc into a
    standalone -fsanitize=address binary and runs it; LeakSanitizer makes
    any leak (or overflow/use-after-free) a nonzero exit."""
    import shutil
    import subprocess

    if shutil.which("g++") is None:
        pytest.skip("no g++")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    exe = str(tmp_path / "leak_check")
    subprocess.run(
        [
            "g++", "-O1", "-g", "-std=c++17", "-fsanitize=address",
            os.path.join(root, "csrc", "bvh_builder.cpp"),
            os.path.join(root, "csrc", "leak_check.cpp"),
            "-o", exe,
        ],
        check=True,
        capture_output=True,
    )
    res = subprocess.run([exe], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "leak_check ok" in res.stdout

"""OBJ / MTL / .lights parser tests (reference semantics)."""

import numpy as np

from pbrjax.io.lights import parse_lights
from pbrjax.io.mtl import parse_mtl
from pbrjax.io.obj import parse_obj


def test_mtl_defaults_and_extensions():
    lib = parse_mtl(
        """
newmtl a
Kd 0.1 0.2 0.3
rough 0.5
nu 10
Rs 0.25

newmtl b
Tr 0.3
"""
    )
    assert lib.names == ["a", "b"]
    a, b = lib.materials
    # defaults per MtlParser.cpp:11-35
    assert a.Ns == 100.0 and a.Ni == 1.0 and a.d == 1.0 and a.illum == 2
    assert a.p == 1.0 and a.nv == 0.0 and a.Rd == 1.0 and a.light == 0
    assert a.Kd == (0.1, 0.2, 0.3) and a.rough == 0.5 and a.nu == 10.0 and a.Rs == 0.25
    # Tr = 1 - d (MtlParser.cpp:102-108)
    assert abs(b.d - 0.7) < 1e-6


def test_mtl_tr_ignored_after_d():
    # The reference's transparency flag is file-global (MtlParser.cpp:57,99).
    lib = parse_mtl("newmtl a\nd 0.4\nnewmtl b\nTr 0.3\n")
    assert abs(lib.materials[0].d - 0.4) < 1e-6
    assert lib.materials[1].d == 1.0  # Tr ignored because d was set earlier


def test_mtl_illum_range():
    lib = parse_mtl("newmtl a\nillum 42\n")
    assert lib.materials[0].illum == 2


def test_lights_parsing():
    lights = parse_lights(
        """
newlight sun
type 2
pos 1 2 3
radius 0.5
rgb 4 5 6
newlight p
type 1
"""
    )
    assert len(lights) == 2
    assert lights[0].type == 2 and lights[0].pos == (1.0, 2.0, 3.0)
    assert lights[0].radius == 0.5 and lights[0].rgb == (4.0, 5.0, 6.0)
    assert lights[1].type == 1 and lights[1].radius == 0.0


def test_obj_face_formats():
    """All four index formats (ObjParser.cpp:258-301)."""
    obj = parse_obj(
        """
o thing
v 0 0 0
v 1 0 0
v 0 1 0
v 1 1 0
vn 0 0 1
vt 0 0
f 1 2 3
f 1/1 2/1 3/1
f 1/1/1 2/1/1 3/1/1
f 2//1 4//1 3//1
"""
    )
    assert obj.num_faces == 4
    np.testing.assert_array_equal(obj.faces_v[0], [0, 1, 2])
    np.testing.assert_array_equal(obj.faces_v[3], [1, 3, 2])
    assert obj.objects[0].name == "thing"
    assert len(obj.objects[0].face_indices) == 4


def test_obj_negative_indices():
    obj = parse_obj("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    np.testing.assert_array_equal(obj.faces_v[0], [0, 1, 2])


def test_obj_usemtl_mapping():
    mtl = parse_mtl("newmtl red\nnewmtl blue\n")
    obj = parse_obj(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nusemtl blue\nf 1 2 3\nusemtl nope\nf 1 2 3\n",
        mtl=mtl,
    )
    # unknown material → -1 (ObjParser.cpp:205-207)
    np.testing.assert_array_equal(obj.faces_mtl, [1, -1])


def test_materials_soa_shapes():
    lib = parse_mtl("newmtl a\nKd 1 0 0\nnewmtl b\nKd 0 1 0\n")
    soa = lib.to_soa()
    assert soa.count == 2
    assert soa.kd.x.shape == (2,)
    np.testing.assert_allclose(soa.kd.y, [0.0, 1.0])

"""Color-matrix tool (pbrjax.tools.colormatrix) vs published constants."""

import numpy as np

from pbrjax.tools.colormatrix import (
    COLOR_SYSTEMS,
    legacy_scale,
    rgb_to_xyz_matrix,
    xyz_to_rgb_matrix,
)

# The reference tool's printed output for its color systems
# (reference source/tools/colormatrix.py:105-133 comment block).
REFERENCE_PRINTED = {
    "NTSC": [
        [6.040009, -1.683788, -0.911408],
        [-3.113923, 6.322208, -0.089522],
        [0.184473, -0.374537, 2.839774],
    ],
    "HDTV": [
        [6.205850, -1.717461, -1.047886],
        [-2.715540, 5.513369, 0.096872],
        [0.193850, -0.393574, 2.984110],
    ],
    "Rec709": [
        [9.854084, -4.674373, -1.516013],
        [-2.944388, 5.698851, 0.126237],
        [0.169153, -0.620228, 3.213911],
    ],
}


def test_rec709_standard_values():
    # Published sRGB/Rec709 D65 XYZ->RGB matrix (IEC 61966-2-1).
    expect = np.array(
        [
            [3.2406, -1.5372, -0.4986],
            [-0.9689, 1.8758, 0.0415],
            [0.0557, -0.2040, 1.0570],
        ]
    )
    # atol covers the rounding of the D65 white point in the published
    # constants (they were derived from a 4-digit chromaticity table).
    np.testing.assert_allclose(xyz_to_rgb_matrix("Rec709"), expect, atol=3e-3)


def test_matches_reference_tool_up_to_luminance_scale():
    for system, printed in REFERENCE_PRINTED.items():
        ours = xyz_to_rgb_matrix(system) * legacy_scale(system)
        np.testing.assert_allclose(ours, np.array(printed), atol=1e-5)


def test_roundtrip_and_white_normalization():
    for system in COLOR_SYSTEMS:
        m = rgb_to_xyz_matrix(system)
        np.testing.assert_allclose(
            m @ np.linalg.inv(m), np.eye(3), atol=1e-12
        )
        xyz_white = m @ np.ones(3)
        assert abs(xyz_white[1] - 1.0) < 1e-12  # Y(white) == 1

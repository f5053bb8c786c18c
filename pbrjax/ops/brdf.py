"""BRDF library: Schlick and Shirley-Ashikhmin eval / sample, plus Fresnel
and refraction.

Vectorized re-derivations of the reference's device BRDF code
(``source/opencl/pt_brdf.cl`` — Schlick zenith/azimuth/Smith factors and
4-quadrant importance sampler :11-208; anisotropic-Phong Shirley-Ashikhmin
lobe + coupled diffuse and its sampler :228-330) and the shared helpers in
``pt_utils.cl`` (Schlick Fresnel :53-68, Fresnel-weighted refraction with
total internal reflection :436-465).

All functions are elementwise over ray batches (SoA ``Vec3`` + scalar
arrays) and backend-agnostic; every division guarded in the reference
(``x == 0 ? 0 : a/x``) is reproduced with ``xp.where`` so NumPy and XLA
produce identical values. Random inputs are passed in explicitly (detached
sampling: the uniforms are RNG-stream constants, so gradients flow through
the *weights*, not the sample positions — SURVEY.md §7.6).
"""

from __future__ import annotations

import numpy as np

from pbrjax.ops.vec import (
    Vec3,
    bisect,
    jitter,
    orthonormal,
    reflect,
    safe_arccos,
    safe_div,
    safe_normalized,
    safe_pow,
    safe_sqrt,
    where3,
)
from pbrjax.utils.config import NI_AIR

PI = np.float32(np.pi)
PI_X2 = np.float32(2.0 * np.pi)
M_1_PI = np.float32(1.0 / np.pi)
M_PI_2 = np.float32(np.pi / 2.0)


def _guarded_div(xp, num, den, zero_if):
    """num / den, but 0 where ``zero_if`` (the reference's x==0 guards)."""
    safe = xp.where(zero_if, np.float32(1.0), den)
    return xp.where(zero_if, np.float32(0.0), num / safe)


def fresnel(u, c):
    """Schlick Fresnel approximation (pt_utils.cl:53-56). Works for scalar
    reflectance ``c`` (float) or per-channel (Vec3, pt_utils.cl:65-68)."""
    v = 1.0 - u
    v5 = v * v * v * v * v
    if isinstance(c, Vec3):
        return c + (1.0 - c) * v5
    return c + (1.0 - c) * v5


# ---------------------------------------------------------------------------
# Schlick BRDF (reference BRDF == 0)
# ---------------------------------------------------------------------------


def _schlick_Z(xp, t, r):
    """Zenith factor (pt_brdf.cl:11-14)."""
    x = 1.0 + r * t * t - t * t
    return _guarded_div(xp, r, x * x, x == 0.0)


def _schlick_A(xp, w, p):
    """Azimuth (anisotropy) factor (pt_brdf.cl:23-28)."""
    p2 = p * p
    w2 = w * w
    x = p2 - p2 * w2 + w2
    return safe_sqrt(_guarded_div(xp, p, x, x == 0.0))


def _schlick_G(xp, v, r):
    """Smith shadowing factor (pt_brdf.cl:37-40)."""
    x = r - r * v + v
    return _guarded_div(xp, v, x, x == 0.0)


def _schlick_D(xp, t, v_out, v_in, w, r, p):
    """Directional factor mixing Lambert / anisotropic / Fresnel parts by
    roughness (pt_brdf.cl:93-112)."""
    b = 4.0 * r * (1.0 - r)
    r_lt = r < 0.5
    a = xp.where(r_lt, np.float32(0.0), 1.0 - b)
    c = xp.where(r_lt, 1.0 - b, np.float32(0.0))
    d = 4.0 * PI * v_out * v_in

    gp = _schlick_G(xp, v_out, r) * _schlick_G(xp, v_in, r)
    b2 = gp * _schlick_Z(xp, t, r) * _schlick_A(xp, w, p) + (1.0 - gp)

    lam = a * M_1_PI
    ani = _guarded_div(xp, b, d, (b == 0.0) | (d == 0.0)) * b2
    fres = _guarded_div(xp, c, v_in, v_in == 0.0)
    return lam + ani + fres


def schlick_eval(xp, normal: Vec3, d_out: Vec3, d_in: Vec3, rough, p):
    """Evaluate the Schlick BRDF (pt_brdf.cl:125-149).

    ``d_out`` is the incoming ray direction (V_OUT = -d_out), ``d_in`` the
    outgoing/light direction. Returns ``(brdf, u, pdf)`` with
    u = h·V_OUT (for the Fresnel term) and pdf = (h·n) / (4π · V_OUT·h).
    """
    v_out_dir = -d_out
    un = safe_normalized(normal.yzx().cross(normal))
    h = bisect(v_out_dir, d_in)
    t = h.dot(normal)
    v_in = d_in.dot(normal)
    v_out = v_out_dir.dot(normal)
    hp = safe_normalized(h.cross(normal).cross(normal))
    w = un.dot(hp)
    u = h.dot(v_out_dir)
    pdf = safe_div(t, 4.0 * PI * h.dot(v_out_dir))
    return _schlick_D(xp, t, v_out, v_in, w, rough, p), u, pdf


def _quadrant_phi(xp, b, iso2):
    """4-quadrant azimuth warp of the Schlick sampler (pt_brdf.cl:172-194).

    Folds uniform b in [0,1) into a quadrant-local b' and maps to phi via
    the anisotropy warp, mirroring into the right quadrant.
    """
    quad = xp.floor(b * 4.0)
    b_loc = 1.0 - 4.0 * ((quad + 1.0) * 0.25 - b)
    b2 = b_loc * b_loc
    phi_base = M_PI_2 * safe_sqrt(
        _guarded_div(xp, iso2 * b2, 1.0 - b2 + b2 * iso2, (1.0 - b2 + b2 * iso2) == 0.0)
    )
    phi = xp.where(
        quad == 0.0,
        phi_base,
        xp.where(
            quad == 1.0,
            PI - phi_base,
            xp.where(quad == 2.0, PI + phi_base, PI_X2 - phi_base),
        ),
    )
    return phi


def schlick_sample(xp, d: Vec3, normal: Vec3, rough, p, ra, rb, rc) -> Vec3:
    """Importance-sample a new direction for the Schlick BRDF
    (newRaySchlick, pt_brdf.cl:159-208).

    ``ra/rb/rc`` are uniforms (rc is the hemisphere-fallback azimuth).
    rough == 0 short-circuits to a perfect mirror.
    """
    iso2 = p * p
    denom = rough - ra * rough + ra
    alpha = safe_arccos(safe_sqrt(_guarded_div(xp, ra, denom, denom == 0.0)))
    phi = _quadrant_phi(xp, rb, iso2)
    phi = xp.where(p < 1.0, phi + M_PI_2, phi)

    h = jitter(normal, phi, xp.sin(alpha), xp.cos(alpha))
    new_dir = reflect(d, h)
    # Below-hemisphere fallback: cosine-weighted sample (pt_brdf.cl:203-205).
    fallback = jitter(normal, PI_X2 * rc, xp.sqrt(ra), xp.sqrt(1.0 - ra))
    new_dir = where3(new_dir.dot(normal) <= 0.0, fallback, new_dir)
    # Perfect mirror when roughness is exactly 0 (pt_brdf.cl:162-164).
    return where3(rough == 0.0, reflect(d, normal), new_dir)


# ---------------------------------------------------------------------------
# Shirley-Ashikhmin BRDF (reference BRDF == 1)
# ---------------------------------------------------------------------------


def sa_eval(xp, normal: Vec3, d_out: Vec3, d_in: Vec3, nu, nv):
    """Evaluate the Shirley-Ashikhmin BRDF (pt_brdf.cl:228-268).

    Returns ``(spec, diff_unit, dotHK1, pdf)``. ``diff_unit`` is the diffuse
    lobe with the Rd factor left OUT (the reference multiplies Rd in at
    pt_brdf.cl:256); the caller applies ``diff_unit * Rd`` and then the
    updateColor weighting — spec·rgbSpec·fresnel(dotHK1, Rs) and
    diff·rgbDiff·(1-Rs) (pathtracing.cl:145-146,168-169).

    One deliberate deviation: ``ps1_num = pow(max(h·n, 0), e)`` clamps the
    base (the reference's ``pow`` returns NaN for negative bases with
    fractional exponents, pt_brdf.cl:252); both our backends clamp the same
    way so parity holds.
    """
    un = safe_normalized(normal.yzx().cross(normal))
    vn = safe_normalized(normal.cross(un))

    k1 = d_in  # to light (pt_brdf.cl:237)
    k2 = -d_out  # to viewer
    h = bisect(k1, k2)

    dot_hu = h.dot(un)
    dot_hv = h.dot(vn)
    dot_hn = h.dot(normal)
    dot_nk1 = normal.dot(k1)
    dot_nk2 = normal.dot(k2)
    dot_hk1 = h.dot(k1)

    ps_e_num = nu * dot_hu * dot_hu + nv * dot_hv * dot_hv
    ps_e = _guarded_div(xp, ps_e_num, 1.0 - dot_hn * dot_hn, dot_hn == 1.0)
    ps0 = xp.sqrt((nu + 1.0) * (nv + 1.0)) * np.float32(0.125) * M_1_PI
    ps1_num = safe_pow(dot_hn, ps_e)
    ps1 = safe_div(ps1_num, dot_hk1 * xp.maximum(dot_nk1, dot_nk2))

    a = 1.0 - dot_nk1 * 0.5
    b = 1.0 - dot_nk2 * 0.5
    pd = np.float32(0.38750768752)  # 28/(23π), pt_brdf.cl:256
    pd = pd * (1.0 - a * a * a * a * a)
    pd = pd * (1.0 - b * b * b * b * b)

    spec = ps0 * ps1
    pdf = safe_div(ps0 * ps1_num, dot_hk1)
    return spec, pd, dot_hk1, pdf


def sa_sample(xp, d: Vec3, normal: Vec3, mtl_d, nu, nv, ra, rb, rc) -> Vec3:
    """Sample the Shirley-Ashikhmin lobe (newRayShirleyAshikhmin,
    pt_brdf.cl:278-330): quadrant-mapped anisotropic half-vector; falls back
    to a cosine-weighted diffuse sample when the specular reflection dips
    under the hemisphere."""
    quad = xp.floor(ra * 4.0)
    a_loc = 1.0 - 4.0 * ((quad + 1.0) * 0.25 - ra)
    phi_flip = xp.where(
        quad == 0.0,
        np.float32(0.0),
        xp.where(quad == 3.0, PI_X2, PI),
    )
    phi_flipf = xp.where((quad == 1.0) | (quad == 3.0), np.float32(-1.0), np.float32(1.0))

    phi = xp.arctan(xp.sqrt((nu + 1.0) / (nv + 1.0)) * xp.tan(M_PI_2 * a_loc))
    phi_full = phi_flip + phi_flipf * phi

    cosphi = xp.cos(phi)
    sinphi = xp.sin(phi)
    theta_e = 1.0 / (nu * cosphi * cosphi + nv * sinphi * sinphi + 1.0)
    theta = safe_arccos(safe_pow(1.0 - rb, theta_e))

    # Use the unflipped normal only when opaque backface (pt_brdf.cl:319).
    n_eff = where3((mtl_d < 1.0) | (normal.dot(-d) >= 0.0), normal, -normal)

    h = jitter(n_eff, phi_full, xp.sin(theta), xp.cos(theta))
    spec = reflect(d, h)
    diff = jitter(n_eff, PI_X2 * rc, xp.sqrt(rb), xp.sqrt(1.0 - rb))
    return where3(spec.dot(n_eff) <= 0.0, diff, spec)


# ---------------------------------------------------------------------------
# Refraction (reference pt_utils.cl:436-465)
# ---------------------------------------------------------------------------


def refract_dir(xp, d: Vec3, normal: Vec3, ni, rand_choice) -> Vec3:
    """Fresnel-weighted refraction/reflection with total internal reflection.

    ``normal`` is the *unflipped* geometric normal (the reference flips only
    after getNewRay, pathtracing.cl:296-300). ``rand_choice`` decides
    reflect-vs-transmit against the Fresnel reflectance.
    """
    into = normal.dot(-d) > 0.0
    nl = where3(into, normal, -normal)
    m1 = xp.where(into, np.float32(NI_AIR), ni)
    m2 = xp.where(into, ni, np.float32(NI_AIR))
    m = m1 / m2

    cos_i = -nl.dot(d)
    sin_t2 = m * m * (1.0 - cos_i * cos_i)
    tir = sin_t2 >= 1.0

    sqrt_cos_t = safe_sqrt(1.0 - sin_t2)
    r0 = (m1 - m2) / (m1 + m2)
    c = xp.where(m1 > m2, sqrt_cos_t, cos_i)
    reflectance = fresnel(c, r0 * r0)

    transmit_dir = d * m + nl * (m * cos_i - sqrt_cos_t)
    refl_dir = reflect(d, nl)
    out = where3(reflectance < rand_choice, transmit_dir, refl_dir)
    return where3(tir, refl_dir, out)

"""Fully independent scalar oracle tracer.

``pbrjax.reference.cpu`` runs the *same* backend-generic integrator with
``xp = numpy`` — it proves backend parity, not correctness: a logic bug in
``trace_rays`` would pass every golden test. This module is the independent
check: a straight-line, one-pixel-at-a-time path tracer that shares **no
code** with ``models/integrator.py`` (not even the vector / BRDF / RNG
helpers — everything is re-implemented here from the reference's semantics,
``source/opencl/pathtracing.cl:207-334`` and the files it includes). Its
control flow is the reference's *dynamic* per-pixel loop (break on miss /
Russian roulette / depth), not the integrator's masked wavefront — so
agreement between the two is evidence the wavefront masking is right.

Everything is computed on NumPy float32 *scalars* (same IEEE rounding as the
integrator's float32 arrays), and the RNG is an inline pure-Python
re-implementation of the counter-based hash (same published lowbias32
constants), so at a fixed seed the oracle draws the identical uniforms.

This is a test oracle: clarity over speed. Run it on tiny crops only.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

F = np.float32
EPS5 = F(1e-5)
INF = F(np.inf)
PI = F(math.pi)
PI2 = F(2.0 * math.pi)
PI_HALF = F(math.pi / 2.0)
INV_PI = F(1.0 / math.pi)

# Stream ids — must agree with ops/rng.py (they define the RNG *protocol*,
# i.e. which uniform feeds which decision; the hash itself is re-implemented
# below).
S_AA_R, S_AA_PHI, S_DOF_R, S_DOF_PHI = 0, 1, 2, 3
S_TRANS, S_REFR, S_BRDF_A, S_BRDF_B, S_BRDF_C, S_EXTEND, S_RR = (
    4, 5, 6, 7, 8, 9, 10,
)


# ---------------------------------------------------------------------------
# RNG: pure-Python integer hash (lowbias32 finalizer + golden-ratio fold).
# ---------------------------------------------------------------------------


def _hash32(x: int) -> int:
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def _fold(h: int, v: int) -> int:
    return _hash32((h ^ ((v * 0x9E3779B9) & 0xFFFFFFFF)) & 0xFFFFFFFF)


def _uniform(frame_seed: int, pixel_id: int, sample: int, bounce: int, stream: int) -> F:
    h = _hash32(frame_seed)
    h = _fold(h, pixel_id)
    h = _fold(h, sample)
    h = _fold(h, bounce)
    h = _fold(h, stream)
    return F(h >> 8) * F(1.0 / (1 << 24))


# ---------------------------------------------------------------------------
# Scalar 3-vector math on float32 numpy scalars. Tuples, no classes.
# ---------------------------------------------------------------------------


def _v(x, y, z):
    return (F(x), F(y), F(z))


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _muls(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _mulv(a, b):
    return (a[0] * b[0], a[1] * b[1], a[2] * b[2])


def _neg(a):
    return (-a[0], -a[1], -a[2])


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _norm(a):
    l2 = _dot(a, a)
    return _muls(a, F(1.0) / np.sqrt(l2))


def _safe_norm(a):
    l2 = _dot(a, a)
    if not l2 > F(1e-20):
        return _v(0, 0, 0)
    return _muls(a, F(1.0) / np.sqrt(l2))


def _safe_sqrt(x):
    return np.sqrt(x) if x > 0.0 else F(0.0)


def _safe_div(num, den, eps=F(1e-12)):
    return num / den if abs(den) > eps else F(0.0)


def _safe_pow(x, e):
    return np.power(x, e) if x > 0.0 else F(0.0)


def _safe_arccos(x):
    if abs(x) < 1.0:
        return np.arccos(x)
    return F(0.0) if x >= 1.0 else PI


def _reflect(d, n):
    return _sub(d, _muls(n, F(2.0) * _dot(n, d)))


def _finite3(a):
    return (
        a[0] if np.isfinite(a[0]) else F(0.0),
        a[1] if np.isfinite(a[1]) else F(0.0),
        a[2] if np.isfinite(a[2]) else F(0.0),
    )


def _tangent_frame(n):
    """u = normalize(n.yzx × n); v = normalize(n × u) (pt_utils.cl:309-310)."""
    u = _safe_norm(_cross((n[1], n[2], n[0]), n))
    v = _safe_norm(_cross(n, u))
    return u, v


def _jitter(nl, phi, sina, cosa):
    """Hemisphere direction at (phi, alpha) around nl (pt_utils.cl:306-318)."""
    u, v = _tangent_frame(nl)
    azim = _norm(_add(_muls(u, np.cos(phi)), _muls(v, np.sin(phi))))
    return _norm(_add(_muls(azim, sina), _muls(nl, cosa)))


# ---------------------------------------------------------------------------
# Intersection (pt_intersect.cl) — straight scalar loops.
# ---------------------------------------------------------------------------


def _moller_trumbore(o, d, v0, e1, e2):
    tvec = _sub(o, v0)
    pvec = _cross(d, e2)
    qvec = _cross(tvec, e1)
    det = _dot(e1, pvec)
    with np.errstate(all="ignore"):
        inv_det = F(1.0) / det
        t = _dot(e2, qvec) * inv_det
        u = _dot(tvec, pvec) * inv_det
        v = _dot(d, qvec) * inv_det
    valid = (t >= EPS5) and (u >= 0.0) and (v >= 0.0) and (u + v <= 1.0)
    return t, valid


def _nearest_hit(o, d, faces) -> Tuple[F, int]:
    """Brute nearest-hit; first face in memory order wins ties."""
    t_best, f_best = INF, -1
    for i, (v0, e1, e2) in enumerate(faces):
        t, ok = _moller_trumbore(o, d, v0, e1, e2)
        if ok and t < t_best:
            t_best, f_best = t, i
    return t_best, f_best


def _any_hit_before(o, d, t_limit, faces) -> bool:
    for v0, e1, e2 in faces:
        t, ok = _moller_trumbore(o, d, v0, e1, e2)
        if ok and t < t_limit:
            return True
    return False


def _sphere_hit(o, d, center, r_sq) -> bool:
    """Geometric ray-sphere, preserving the reference's radius² quirk
    (pt_intersect.cl:37-77)."""
    L = _sub(center, o)
    tca = _dot(L, d)
    d2 = _dot(L, L) - tca * tca
    thc = np.sqrt(np.maximum(r_sq - d2, F(0.0)))
    t0 = tca - thc
    t1 = tca + thc
    t_near = t1 if t0 < 0.0 else t0
    return bool((tca >= 0.0) and (d2 <= r_sq) and (t_near >= 0.0))


# ---------------------------------------------------------------------------
# BRDFs (pt_brdf.cl) — scalar re-derivations.
# ---------------------------------------------------------------------------


def _fresnel_s(u, c):
    v = F(1.0) - u
    return c + (F(1.0) - c) * (v * v * v * v * v)


def _fresnel3(u, c3):
    return (
        _fresnel_s(u, c3[0]),
        _fresnel_s(u, c3[1]),
        _fresnel_s(u, c3[2]),
    )


def _schlick_eval(n, d_out, d_in, rough, p):
    """(brdf, u, pdf) — pt_brdf.cl:125-149 via Z/A/G/D factors (:11-112)."""
    v_out_dir = _neg(d_out)
    un = _safe_norm(_cross((n[1], n[2], n[0]), n))
    h = _safe_norm(_add(v_out_dir, d_in))
    t = _dot(h, n)
    v_in = _dot(d_in, n)
    v_out = _dot(v_out_dir, n)
    hp = _safe_norm(_cross(_cross(h, n), n))
    w = _dot(un, hp)
    u = _dot(h, v_out_dir)
    pdf = _safe_div(t, F(4.0) * PI * _dot(h, v_out_dir))

    # D (pt_brdf.cl:93-112)
    b = F(4.0) * rough * (F(1.0) - rough)
    if rough < 0.5:
        a, c = F(0.0), F(1.0) - b
    else:
        a, c = F(1.0) - b, F(0.0)
    dd = F(4.0) * PI * v_out * v_in

    def Z(tt):
        x = F(1.0) + rough * tt * tt - tt * tt
        return F(0.0) if x * x == 0.0 else rough / (x * x)

    def A(ww):
        p2 = p * p
        w2 = ww * ww
        x = p2 - p2 * w2 + w2
        return _safe_sqrt(F(0.0) if x == 0.0 else p / x)

    def G(vv):
        x = rough - rough * vv + vv
        return F(0.0) if x == 0.0 else vv / x

    gp = G(v_out) * G(v_in)
    b2 = gp * Z(t) * A(w) + (F(1.0) - gp)
    lam = a * INV_PI
    ani = (F(0.0) if (b == 0.0 or dd == 0.0) else b / dd) * b2
    fres = F(0.0) if v_in == 0.0 else c / v_in
    return lam + ani + fres, u, pdf


def _schlick_sample(d, n, rough, p, ra, rb, rc):
    """newRaySchlick (pt_brdf.cl:159-208)."""
    if rough == 0.0:
        return _reflect(d, n)
    iso2 = p * p
    denom = rough - ra * rough + ra
    alpha = _safe_arccos(_safe_sqrt(F(0.0) if denom == 0.0 else ra / denom))
    # 4-quadrant azimuth warp (pt_brdf.cl:172-194).
    quad = np.floor(rb * F(4.0))
    b_loc = F(1.0) - F(4.0) * ((quad + F(1.0)) * F(0.25) - rb)
    b2 = b_loc * b_loc
    den2 = F(1.0) - b2 + b2 * iso2
    phi_base = PI_HALF * _safe_sqrt(F(0.0) if den2 == 0.0 else iso2 * b2 / den2)
    if quad == 0.0:
        phi = phi_base
    elif quad == 1.0:
        phi = PI - phi_base
    elif quad == 2.0:
        phi = PI + phi_base
    else:
        phi = PI2 - phi_base
    if p < 1.0:
        phi = phi + PI_HALF
    h = _jitter(n, phi, np.sin(alpha), np.cos(alpha))
    new_dir = _reflect(d, h)
    if _dot(new_dir, n) <= 0.0:
        new_dir = _jitter(n, PI2 * rc, np.sqrt(ra), np.sqrt(F(1.0) - ra))
    return new_dir


def _sa_eval(n, d_out, d_in, nu, nv):
    """(spec, diff_unit, dotHK1, pdf) — pt_brdf.cl:228-268."""
    un = _safe_norm(_cross((n[1], n[2], n[0]), n))
    vn = _safe_norm(_cross(n, un))
    k1 = d_in
    k2 = _neg(d_out)
    h = _safe_norm(_add(k1, k2))
    dot_hu = _dot(h, un)
    dot_hv = _dot(h, vn)
    dot_hn = _dot(h, n)
    dot_nk1 = _dot(n, k1)
    dot_nk2 = _dot(n, k2)
    dot_hk1 = _dot(h, k1)

    ps_e_num = nu * dot_hu * dot_hu + nv * dot_hv * dot_hv
    ps_e = F(0.0) if dot_hn == 1.0 else ps_e_num / (F(1.0) - dot_hn * dot_hn)
    ps0 = np.sqrt((nu + F(1.0)) * (nv + F(1.0))) * F(0.125) * INV_PI
    ps1_num = _safe_pow(dot_hn, ps_e)
    ps1 = _safe_div(ps1_num, dot_hk1 * np.maximum(dot_nk1, dot_nk2))

    a = F(1.0) - dot_nk1 * F(0.5)
    b = F(1.0) - dot_nk2 * F(0.5)
    pd = F(0.38750768752)  # 28/(23π)
    pd = pd * (F(1.0) - a * a * a * a * a)
    pd = pd * (F(1.0) - b * b * b * b * b)

    spec = ps0 * ps1
    pdf = _safe_div(ps0 * ps1_num, dot_hk1)
    return spec, pd, dot_hk1, pdf


def _sa_sample(d, n, mtl_d, nu, nv, ra, rb, rc):
    """newRayShirleyAshikhmin (pt_brdf.cl:278-330)."""
    quad = np.floor(ra * F(4.0))
    a_loc = F(1.0) - F(4.0) * ((quad + F(1.0)) * F(0.25) - ra)
    if quad == 0.0:
        phi_flip, phi_flipf = F(0.0), F(1.0)
    elif quad == 1.0:
        phi_flip, phi_flipf = PI, F(-1.0)
    elif quad == 2.0:
        phi_flip, phi_flipf = PI, F(1.0)
    else:
        phi_flip, phi_flipf = PI2, F(-1.0)

    phi = np.arctan(np.sqrt((nu + F(1.0)) / (nv + F(1.0))) * np.tan(PI_HALF * a_loc))
    phi_full = phi_flip + phi_flipf * phi

    cosphi = np.cos(phi)
    sinphi = np.sin(phi)
    theta_e = F(1.0) / (nu * cosphi * cosphi + nv * sinphi * sinphi + F(1.0))
    theta = _safe_arccos(_safe_pow(F(1.0) - rb, theta_e))

    n_eff = n if (mtl_d < 1.0 or _dot(n, _neg(d)) >= 0.0) else _neg(n)
    h = _jitter(n_eff, phi_full, np.sin(theta), np.cos(theta))
    spec = _reflect(d, h)
    if _dot(spec, n_eff) <= 0.0:
        return _jitter(n_eff, PI2 * rc, np.sqrt(rb), np.sqrt(F(1.0) - rb))
    return spec


def _refract(d, n, ni, rand_choice, ni_air=F(1.0)):
    """Fresnel-weighted refraction with TIR (pt_utils.cl:436-465)."""
    into = _dot(n, _neg(d)) > 0.0
    nl = n if into else _neg(n)
    m1 = ni_air if into else ni
    m2 = ni if into else ni_air
    m = m1 / m2

    cos_i = -_dot(nl, d)
    sin_t2 = m * m * (F(1.0) - cos_i * cos_i)
    refl_dir = _reflect(d, nl)
    if sin_t2 >= 1.0:
        return refl_dir  # total internal reflection
    sqrt_cos_t = _safe_sqrt(F(1.0) - sin_t2)
    r0 = (m1 - m2) / (m1 + m2)
    c = sqrt_cos_t if m1 > m2 else cos_i
    reflectance = _fresnel_s(c, r0 * r0)
    if reflectance < rand_choice:
        return _add(_muls(d, m), _muls(nl, m * cos_i - sqrt_cos_t))
    return refl_dir


# ---------------------------------------------------------------------------
# The per-pixel tracer: the reference's dynamic path loop, literally
# (pathtracing.cl:207-334).
# ---------------------------------------------------------------------------


def _scene_tables(scene):
    """Pull Scene pytree leaves into plain Python structures."""
    tris = scene.tris
    nf = int(np.asarray(tris.mtl).shape[0])
    g = lambda v, i: _v(np.asarray(v.x)[i], np.asarray(v.y)[i], np.asarray(v.z)[i])  # noqa: E731
    faces = [(g(tris.v0, i), g(tris.e1, i), g(tris.e2, i)) for i in range(nf)]
    mtl_of = [int(np.asarray(tris.mtl)[i]) for i in range(nf)]

    m = scene.materials
    mats = []
    for i in range(int(np.asarray(m.d).shape[0])):
        mats.append(
            dict(
                d=F(np.asarray(m.d)[i]),
                Ni=F(np.asarray(m.Ni)[i]),
                rough=F(np.asarray(m.rough)[i]),
                p=F(np.asarray(m.p)[i]),
                nu=F(np.asarray(m.nu)[i]),
                nv=F(np.asarray(m.nv)[i]),
                Rs=F(np.asarray(m.Rs)[i]),
                Rd=F(np.asarray(m.Rd)[i]),
                kd=g(m.kd, i),
                ks=g(m.ks, i),
            )
        )
    li = scene.lights
    lights = []
    for i in range(int(np.asarray(li.radius).shape[0])):
        lights.append(
            dict(
                pos=g(li.pos, i),
                rgb=g(li.rgb, i),
                radius=F(np.asarray(li.radius)[i]),
                type=int(np.asarray(li.type)[i]),
            )
        )
    return faces, mtl_of, mats, lights


def trace_pixel(
    faces,
    mtl_of,
    mats,
    lights,
    cam,
    settings,
    pixel_id: int,
    frame_seed: int,
    prev_t: F = INF,
) -> Tuple[Tuple[F, F, F], F]:
    """Trace all samples of one pixel. Returns ((r, g, b), focus_t)."""
    from pbrjax.utils.config import BRDF_SCHLICK

    w, h = settings.width, settings.height
    px = F(pixel_id % w)
    py = F(pixel_id // w)
    aspect = F(float(w) / float(h))
    fimg = aspect * F(2.0) * F(math.tan(math.radians(settings.fov) * 0.5))
    pxdim = F(fimg / F(w))

    eye = _v(float(np.asarray(cam.eye.x)), float(np.asarray(cam.eye.y)), float(np.asarray(cam.eye.z)))
    cw = _v(float(np.asarray(cam.w.x)), float(np.asarray(cam.w.y)), float(np.asarray(cam.w.z)))
    cu = _v(float(np.asarray(cam.u.x)), float(np.asarray(cam.u.y)), float(np.asarray(cam.u.z)))
    cv = _v(float(np.asarray(cam.v.x)), float(np.asarray(cam.v.y)), float(np.asarray(cam.v.z)))
    cam_focus = F(np.asarray(cam.focus))
    lens = F(np.asarray(cam.focal_length)) / F(np.asarray(cam.aperture))

    sky = _v(*settings.sky_light)
    nee = bool(settings.shadow_rays) and len(lights) > 0
    schlick = settings.brdf == BRDF_SCHLICK

    def u_(s, b, stream):
        return _uniform(frame_seed, pixel_id, s, b, stream)

    final = _v(0, 0, 0)
    secondary = 1  # starts at 1, shared across samples (pathtracing.cl:249)
    focus_t = INF

    for s in range(settings.samples):
        # -- primary ray: pinhole + AA + DoF (initRay; pt_utils.cl:327,349) --
        fx = F(1.0) - F(w) + F(2.0) * px
        fy = F(1.0) - F(h) + F(2.0) * py
        d = _norm(_add(cw, _muls(_add(_muls(cu, fx), _muls(cv, fy)), pxdim * F(0.5))))
        rnd = u_(s, 0, S_AA_R)
        phi = PI2 * u_(s, 0, S_AA_PHI)
        aa = _jitter(d, phi, np.sqrt(rnd), np.sqrt(F(1.0) - rnd))
        d = _norm(_add(d, _muls(aa, pxdim * F(settings.anti_aliasing))))
        o = eye
        t_obj = prev_t if np.isfinite(prev_t) else F(1000.0)
        t_foc = cam_focus if np.isfinite(cam_focus) else F(1000.0)
        if cam_focus >= 0.0 and t_obj > 0.0:
            radius = u_(s, 0, S_DOF_R) * lens * F(0.5)
            angle = PI2 * u_(s, 0, S_DOF_PHI)
            o = _add(
                _add(eye, _muls(cu, radius * np.cos(angle))),
                _muls(cv, radius * np.sin(angle)),
            )
            d = _norm(_sub(_add(eye, _muls(d, t_foc)), o))

        color = _v(1, 1, 1)
        depth_added = 0
        emission = None  # set on miss (sky or orb)

        depth = 0
        while depth < settings.max_depth + depth_added:
            t, face = _nearest_hit(o, d, faces)

            # orb pass: last orb hit in light order wins; only on geom miss
            # (traverseLights, pt_bvh.cl:54-74).
            orb_idx = -1
            for i, L in enumerate(lights):
                if L["type"] == 2 and _sphere_hit(o, d, L["pos"], L["radius"]):
                    orb_idx = i

            if s == 0 and depth == 0:
                focus_t = t

            if not np.isfinite(t):
                emission = lights[orb_idx]["rgb"] if orb_idx >= 0 else sky
                break

            mtl = mats[mtl_of[face]]
            v0, e1, e2 = faces[face]
            normal = _norm(_cross(e1, e2))

            # extension decision (extendDepth, pt_utils.cl:89-96)
            if schlick:
                extend = mtl["rough"] < u_(s, depth, S_EXTEND)
            else:
                extend = max(mtl["nu"], mtl["nv"]) >= 50.0

            # opportunistic last-bounce break (pathtracing.cl:274-276)
            is_last = depth == (settings.max_depth + depth_added - 1)
            if mtl["d"] == 1.0 and not extend and is_last:
                break

            hit_p = _add(o, _muls(d, t))

            # new direction (getNewRay, pt_brdf.cl:344-378)
            r_trans = u_(s, depth, S_TRANS)
            do_trans = (mtl["d"] < 1.0) and (mtl["d"] <= r_trans)
            ra = u_(s, depth, S_BRDF_A)
            rb = u_(s, depth, S_BRDF_B)
            rc = u_(s, depth, S_BRDF_C)
            if do_trans:
                new_d = _refract(d, normal, mtl["Ni"], u_(s, depth, S_REFR))
            elif schlick:
                new_d = _schlick_sample(d, normal, mtl["rough"], mtl["p"], ra, rb, rc)
            else:
                new_d = _sa_sample(d, normal, mtl["d"], mtl["nu"], mtl["nv"], ra, rb, rc)

            # flip normal toward viewer (pathtracing.cl:296-300)
            n_sh = normal if _dot(normal, _neg(d)) > 0.0 else _neg(normal)

            # NEE (shadowRayTest, pathtracing.cl:188-199)
            nee_ok = False
            l_dir = _v(0, 0, 0)
            if nee and mtl["d"] > 0.0:
                l_vec = _sub(lights[0]["pos"], hit_p)
                t_light = _safe_sqrt(_dot(l_vec, l_vec))
                l_dir = _muls(l_vec, _safe_div(F(1.0), t_light))
                nee_ok = not _any_hit_before(hit_p, l_dir, t_light, faces)

            # throughput & NEE contribution (updateColor, pathtracing.cl:92-178)
            if schlick:
                if nee_ok:
                    brdf_l, u_l, pdf_l = _schlick_eval(
                        n_sh, d, l_dir, mtl["rough"], mtl["p"]
                    )
                    if abs(pdf_l) > F(1e-5):
                        w_l = brdf_l * np.maximum(_dot(n_sh, l_dir), F(0.0)) / pdf_l
                        fr = _fresnel3(u_l, mtl["ks"])
                        base = (
                            fr[0] * w_l * mtl["d"] + (F(1.0) - mtl["d"]),
                            fr[1] * w_l * mtl["d"] + (F(1.0) - mtl["d"]),
                            fr[2] * w_l * mtl["d"] + (F(1.0) - mtl["d"]),
                        )
                        contrib = _mulv(_mulv(_mulv(color, lights[0]["rgb"]), mtl["kd"]), base)
                        final = _add(final, _finite3(contrib))
                        secondary += 1
                brdf_b, u_b, pdf_b = _schlick_eval(n_sh, d, new_d, mtl["rough"], mtl["p"])
                pdf_bs = pdf_b if abs(pdf_b) > F(1e-7) else F(1.0)
                w_b = brdf_b * np.maximum(_dot(n_sh, new_d), F(0.0)) / pdf_bs
                fr = _fresnel3(u_b, mtl["ks"])
                mult = _finite3(
                    (
                        mtl["kd"][0] * (fr[0] * w_b * mtl["d"] + (F(1.0) - mtl["d"])),
                        mtl["kd"][1] * (fr[1] * w_b * mtl["d"] + (F(1.0) - mtl["d"])),
                        mtl["kd"][2] * (fr[2] * w_b * mtl["d"] + (F(1.0) - mtl["d"])),
                    )
                )
                color = _mulv(color, mult)
            else:

                def sa_weight(spec, diff, hk1, pdf):
                    b_s = (spec / pdf) * _fresnel_s(hk1, mtl["Rs"])
                    b_d = (diff * mtl["Rd"] / pdf) * (F(1.0) - mtl["Rs"])
                    bc = (
                        mtl["ks"][0] * b_s + mtl["kd"][0] * b_d,
                        mtl["ks"][1] * b_s + mtl["kd"][1] * b_d,
                        mtl["ks"][2] * b_s + mtl["kd"][2] * b_d,
                    )
                    bc = tuple(c * mtl["d"] + (F(1.0) - mtl["d"]) for c in bc)
                    mx = np.maximum(F(1.0), np.maximum(bc[0], np.maximum(bc[1], bc[2])))
                    return tuple(np.clip(c / mx, F(0.0), F(1.0)) for c in bc)

                if nee_ok:
                    spec_l, diff_l, hk1_l, pdf_l = _sa_eval(n_sh, d, l_dir, mtl["nu"], mtl["nv"])
                    if abs(pdf_l) > F(1e-5):
                        bc = sa_weight(spec_l, diff_l, hk1_l, pdf_l)
                        contrib = tuple(
                            bc[i] * lights[0]["rgb"][i] * mtl["d"] + (F(1.0) - mtl["d"])
                            for i in range(3)
                        )
                        final = _add(final, _finite3(contrib))
                        secondary += 1
                spec_b, diff_b, hk1_b, pdf_b = _sa_eval(n_sh, d, new_d, mtl["nu"], mtl["nv"])
                pdf_bs = pdf_b if abs(pdf_b) > F(1e-7) else F(1.0)
                color = _mulv(color, _finite3(sa_weight(spec_b, diff_b, hk1_b, pdf_bs)))

            # extend the depth budget (pathtracing.cl:308)
            if (extend or do_trans) and depth_added < settings.max_added_depth:
                depth_added += 1

            # Russian roulette (pt_utils.cl:385-387)
            max_col = np.maximum(color[0], np.maximum(color[1], color[2]))
            if depth > 2 + depth_added and max_col < u_(s, depth, S_RR):
                depth += 1
                break

            o = hit_p
            d = new_d
            depth += 1

        if emission is not None:
            final = _add(final, _mulv(color, emission))

    final = _muls(final, F(1.0) / F(secondary))
    if settings.samples > 1:
        final = _muls(final, F(1.0) / F(settings.samples))
    return final, focus_t


def render_scalar(
    scene,
    cam,
    settings,
    frame_seed: int = 0,
    pixel_ids: Optional[np.ndarray] = None,
    prev_t: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render pixels one at a time. Returns ``(rgb (P,3), focus (P,))`` for
    the given ``pixel_ids`` (default: the full image in row-major order).

    Slow by design — use tiny crops (e.g. 8×8) in tests.
    """
    assert settings.phong_tessellation == 0.0, "scalar oracle is flat-geometry only"
    faces, mtl_of, mats, lights = _scene_tables(scene)
    if pixel_ids is None:
        pixel_ids = np.arange(settings.width * settings.height, dtype=np.int64)
    rgb = np.zeros((len(pixel_ids), 3), dtype=np.float32)
    foc = np.zeros((len(pixel_ids),), dtype=np.float32)
    with np.errstate(all="ignore"):
        for j, pid in enumerate(np.asarray(pixel_ids).tolist()):
            pt = INF if prev_t is None else F(np.asarray(prev_t).reshape(-1)[j])
            c, ft = trace_pixel(
                faces, mtl_of, mats, lights, cam, settings, int(pid), frame_seed, pt
            )
            rgb[j] = c
            foc[j] = ft
    return rgb, foc

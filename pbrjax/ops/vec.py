"""Structure-of-arrays 3-vector math, backend-agnostic (NumPy or jax.numpy).

Layout decision: a batch of N 3-vectors is *three* arrays of shape (N,) —
never an (N, 3) array. A trailing dim of 3 makes strided, partly-used loads
and blocks fusion; component-wise math keeps every op a contiguous
full-width elementwise op and lets XLA fuse whole shading expressions into a handful of kernels. (The reference used OpenCL
float3/float4 per work-item — the per-lane AoS equivalent; see e.g.
pt_header.cl:24-30.)

``Vec3`` is a NamedTuple, hence automatically a JAX pytree: it can be passed
through ``jit``/``grad``/``shard_map`` transparently, with each component
sharded independently.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Vec3(NamedTuple):
    x: object
    y: object
    z: object

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __radd__(self, o):
        return self.__add__(o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- products -----------------------------------------------------------
    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def yzx(self) -> "Vec3":
        """Component swizzle (OpenCL ``v.yzx``), used by the reference's
        tangent-frame construction (pt_utils.cl:309, pt_brdf.cl:132)."""
        return Vec3(self.y, self.z, self.x)

    # -- norms --------------------------------------------------------------
    def length2(self):
        return self.dot(self)

    def length(self):
        return _sqrt_like(self.length2())

    def normalized(self) -> "Vec3":
        return self * _rsqrt_like(self.length2())

    def max_component(self):
        return _maximum(_maximum(self.x, self.y), self.z)

    # -- construction -------------------------------------------------------
    @staticmethod
    def full(xp, shape, vals, dtype=np.float32) -> "Vec3":
        vx, vy, vz = vals
        return Vec3(
            xp.full(shape, vx, dtype=dtype),
            xp.full(shape, vy, dtype=dtype),
            xp.full(shape, vz, dtype=dtype),
        )

    @staticmethod
    def from_array(a) -> "Vec3":
        """From an (..., 3) array (host-side convenience)."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def stack(self, xp=np):
        """To an (..., 3) array (host-side convenience; not for hot paths)."""
        return xp.stack([self.x, self.y, self.z], axis=-1)

    def astype(self, dtype) -> "Vec3":
        return Vec3(self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype))


def _maximum(a, b):
    # jnp and np both expose maximum via the array's module; use duck typing.
    mod = _xp_of(a)
    return mod.maximum(a, b)


def _xp_of(a):
    """Return the array module (numpy or jax.numpy) owning ``a``."""
    t = type(a).__module__
    if t.startswith("jax") or t.startswith("jaxlib"):
        import jax.numpy as jnp

        return jnp
    return np


def _sqrt_like(a):
    return _xp_of(a).sqrt(a)


def _rsqrt_like(a):
    # 1/sqrt rather than a hardware rsqrt approximation: IEEE sqrt and
    # divide are correctly rounded on both NumPy and XLA CPU, which keeps
    # ray directions bitwise identical between the oracle and the compiled
    # path and minimizes chaotic per-pixel divergence (XLA fuses this into
    # the surrounding expression anyway).
    return 1.0 / _xp_of(a).sqrt(a)


# ---------------------------------------------------------------------------
# Backward-safe math: forward-exact on the valid domain, zero (not NaN)
# gradients at the boundary. The standard `where` trick is not enough — the
# VJP of sqrt/pow/arccos multiplies the (zeroed) cotangent by an infinite
# local derivative, and 0 * inf = NaN poisons the whole gradient. These
# helpers guard the *input* so the infinite derivative is never formed.
# ---------------------------------------------------------------------------


def safe_sqrt(x):
    """sqrt(x) for x > 0, exactly; 0 at x <= 0 with zero gradient."""
    mod = _xp_of(x)
    pos = x > 0.0
    return mod.where(pos, mod.sqrt(mod.where(pos, x, 1.0)), 0.0)


def safe_pow(x, e):
    """x**e for x > 0, exactly; 0 at x <= 0 with zero gradient.

    (The reference's ``pow`` NaNs for negative bases with fractional
    exponents, e.g. pt_brdf.cl:252; both backends use this clamp.)
    """
    mod = _xp_of(x)
    pos = x > 0.0
    return mod.where(pos, mod.power(mod.where(pos, x, 1.0), e), 0.0)


def safe_arccos(x):
    """arccos with clamped domain and finite gradients at the endpoints."""
    mod = _xp_of(x)
    inside = mod.abs(x) < 1.0
    core = mod.arccos(mod.where(inside, x, 0.0))
    ends = mod.where(x >= 1.0, np.float32(0.0), np.float32(np.pi))
    return mod.where(inside, core, ends)


def safe_div(num, den, eps=1e-12):
    """num / den where |den| > eps, else 0 — with zero gradient there."""
    mod = _xp_of(den)
    ok = mod.abs(den) > eps
    return mod.where(ok, num / mod.where(ok, den, 1.0), 0.0)


def safe_normalized(v: "Vec3", eps=1e-20) -> "Vec3":
    """Unit vector; zero vector (zero grad) for degenerate input."""
    mod = _xp_of(v.x)
    l2 = v.length2()
    ok = l2 > eps
    inv = mod.where(ok, 1.0 / mod.sqrt(mod.where(ok, l2, 1.0)), 0.0)
    return v * inv


def where3(mask, a: Vec3, b: Vec3) -> Vec3:
    """Component-wise ``where`` over Vec3 (works for np and jnp masks)."""
    mod = _xp_of(mask)
    return Vec3(
        mod.where(mask, a.x, b.x),
        mod.where(mask, a.y, b.y),
        mod.where(mask, a.z, b.z),
    )


def reflect(d: Vec3, n: Vec3) -> Vec3:
    """Mirror reflection (reference ``reflect`` macro, pt_utils.cl:426)."""
    return d - n * (2.0 * n.dot(d))


def bisect(v: Vec3, w: Vec3) -> Vec3:
    """Normalized half-vector (reference ``bisect`` macro, pt_utils.cl:7);
    zero (not NaN) for exactly opposite inputs, with zero gradient."""
    return safe_normalized(v + w)


def project_on_plane(q: Vec3, p: Vec3, n: Vec3) -> Vec3:
    """Project point q on the plane through p with unit normal n
    (reference pt_utils.cl:397-399)."""
    return q - n * (q - p).dot(n)


def orthonormal(n: Vec3) -> tuple:
    """Tangent frame (u, v) for unit normal n, the reference's way:
    ``u = normalize(cross(n.yzx, n)); v = normalize(cross(n, u))``
    (pt_utils.cl:309-310). Degenerate when n ∥ n.yzx, as in the reference.
    """
    u = safe_normalized(n.yzx().cross(n))
    v = safe_normalized(n.cross(u))
    return u, v


def jitter(nl: Vec3, phi, sina, cosa) -> Vec3:
    """Direction on the hemisphere around ``nl`` at angle (phi, alpha)
    (reference pt_utils.cl:306-318). ``sina``/``cosa`` are sin/cos of the
    polar angle; cosine-weighted sampling passes sqrt(u), sqrt(1-u).
    """
    mod = _xp_of(nl.x)
    u, v = orthonormal(nl)
    azim = (u * mod.cos(phi) + v * mod.sin(phi)).normalized()
    return (azim * sina + nl * cosa).normalized()

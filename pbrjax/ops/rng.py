"""Counter-based RNG, identical under NumPy and JAX.

The reference used a fract(sin) hash advanced by a mutable float seed
(pt_utils.cl:39-44) — non-reproducible across work sizes and useless for
testing. Here every random number is a *pure function* of
``(frame_seed, pixel_id, sample, bounce, stream)`` via a chain of lowbias32
integer hashes. Consequences:

- deterministic across shardings / device counts (a pixel's randoms do not
  depend on which chip computes it) — required for the multi-host
  allclose gate (SURVEY.md §7 "Multi-host determinism");
- the NumPy oracle tracer and the jax renderer produce *bitwise identical*
  uniforms, so golden tests compare real math, not RNG drift;
- conditional consumption is free (streams are indexed by purpose, not by
  sequence position), which is exactly what masked wavefront execution needs.

All functions work on either ``numpy`` or ``jax.numpy`` arrays — uint32
arithmetic wraps identically in both.
"""

from __future__ import annotations

import numpy as np

# Stream ids — one per distinct random decision in the integrator.
# (bounce-independent streams use bounce=0)
S_AA_R = 0  # anti-aliasing jitter radius      (pt_utils.cl:327-337)
S_AA_PHI = 1  # anti-aliasing jitter angle
S_DOF_R = 2  # depth-of-field lens radius       (pt_utils.cl:349-373)
S_DOF_PHI = 3  # depth-of-field lens angle
S_TRANS = 4  # transparency choice              (pt_brdf.cl:352 getNewRay)
S_REFR = 5  # reflect-vs-transmit choice       (pt_utils.cl:460 refract)
S_BRDF_A = 6  # BRDF sampler uniform a
S_BRDF_B = 7  # BRDF sampler uniform b
S_BRDF_C = 8  # BRDF sampler fallback phi
S_EXTEND = 9  # path-extension decision          (pt_utils.cl:89-96 extendDepth)
S_RR = 10  # Russian roulette                 (pt_utils.cl:385-387)

_M1 = np.uint32(0x7FEB352D)
_M2 = np.uint32(0x846CA68B)
_GOLDEN = np.uint32(0x9E3779B9)
_INV_2_24 = np.float32(1.0 / (1 << 24))


def _is_scalar_int(x) -> bool:
    return isinstance(x, (int, np.integer))


def lowbias32(x):
    """Integer finalizer hash (public-domain 'lowbias32' constants).

    Scalar Python/NumPy ints take a pure-Python path with explicit 32-bit
    masks: NumPy *arrays* wrap uint32 arithmetic silently, but NumPy
    *scalars* emit RuntimeWarning on overflow — the wraparound is the whole
    point here, so scalars never go through NumPy scalar arithmetic.
    """
    if _is_scalar_int(x):
        x = int(x) & 0xFFFFFFFF
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        x ^= x >> 16
        return np.uint32(x)
    x = x.astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    x = (x * _M1).astype(np.uint32)
    x = x ^ (x >> np.uint32(15))
    x = (x * _M2).astype(np.uint32)
    x = x ^ (x >> np.uint32(16))
    return x


def fold(h, v):
    """Fold a value into a hash state (boost::hash_combine-style).

    Same scalar-vs-array split as ``lowbias32`` (uint32-clean wraparound on
    both paths, identical results)."""
    if _is_scalar_int(h) and _is_scalar_int(v):
        return lowbias32((int(h) ^ ((int(v) * 0x9E3779B9) & 0xFFFFFFFF)) & 0xFFFFFFFF)
    if _is_scalar_int(v):
        vg = np.uint32((int(v) * 0x9E3779B9) & 0xFFFFFFFF)
    else:
        vg = (v.astype(np.uint32) * _GOLDEN).astype(np.uint32)
    if _is_scalar_int(h):
        h = np.uint32(int(h) & 0xFFFFFFFF)
    else:
        h = h.astype(np.uint32)
    return lowbias32(h ^ vg)


def _as_u32(v):
    """Coerce a Python/numpy int to np.uint32; pass arrays/tracers through."""
    if isinstance(v, (int, np.integer)):
        return np.uint32(int(v) & 0xFFFFFFFF)
    return v


def uniform(frame_seed, pixel_id, sample, bounce, stream):
    """Uniform float32 in [0, 1) for the given counter coordinates.

    Any argument may be an array (they broadcast); the result dtype is
    float32. Uses the top 24 bits so float32 represents the value exactly.
    """
    h = lowbias32(_as_u32(frame_seed))
    h = fold(h, _as_u32(pixel_id))
    h = fold(h, _as_u32(sample))
    h = fold(h, _as_u32(bounce))
    h = fold(h, _as_u32(stream))
    return (h >> np.uint32(8)).astype(np.float32) * _INV_2_24


class BounceRng:
    """Per-(sample, bounce) bound RNG state (see PixelRng.at)."""

    __slots__ = ("_h",)

    def __init__(self, h):
        self._h = h

    def u(self, stream):
        h = fold(self._h, _as_u32(stream))
        return (h >> np.uint32(8)).astype(np.float32) * _INV_2_24


class PixelRng:
    """Convenience wrapper binding (frame_seed, pixel_id) once.

    ``u(sample, bounce, stream)`` returns uniforms shaped like ``pixel_id``.
    ``frame_seed`` may be a Python int or a traced uint32 scalar (so a
    progressive renderer can vary the seed per frame without recompiling).
    """

    def __init__(self, frame_seed, pixel_id):
        # Pre-fold the per-frame and per-pixel part once.
        h = lowbias32(_as_u32(frame_seed))
        self._base = fold(h, _as_u32(pixel_id))

    def u(self, sample, bounce, stream):
        """``sample``/``bounce``/``stream`` may be Python ints or traced
        integer scalars (the integrator's scan carries the bounce index)."""
        return self.at(sample, bounce).u(stream)

    def at(self, sample, bounce) -> "BounceRng":
        """Bind (sample, bounce) once: the integrator draws ~7 streams per
        bounce, and hoisting the shared ``fold(sample); fold(bounce)``
        prefix out of every draw cuts the per-draw hash chain from 3 folds
        to 1 — bitwise-identical uniforms (pure common-subexpression
        hoisting of a deterministic hash), ~2/3 fewer RNG ops per bounce."""
        return BounceRng(fold(fold(self._base, _as_u32(sample)), _as_u32(bounce)))

    def gather(self, idx):
        """A PixelRng for the sub-batch ``pixel_id[idx]``.

        Gathers the pre-folded per-pixel state, so the sub-batch draws the
        *same* uniforms those pixels would draw at full width — what makes
        live-lane compaction in the integrator bitwise exact.
        """
        r = object.__new__(PixelRng)
        r._base = self._base[idx]
        return r

    def gather_rows(self, src, block: int):
        """A PixelRng for a row-compacted sub-batch (integrator
        ``_compact_rows``): rows of ``block`` consecutive lanes gathered by
        row index. Same pre-folded state, so the sub-batch draws the same
        uniforms those pixels would draw at full width."""
        r = object.__new__(PixelRng)
        r._base = self._base.reshape(-1, block)[src].reshape(-1)
        return r

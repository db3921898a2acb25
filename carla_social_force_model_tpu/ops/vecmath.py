"""Branchless 2-D vector math primitives shared by all force kernels.

These are the vectorized (masked, zero-safe, fixed-shape) equivalents of the
reference's numpy helpers (see /root/reference/stateutils.py:7-128): zero-safe
normalization, velocity capping, and signed 2-D angle differences with +-pi
wrapping.  Everything here is pure jnp, works under jit/vmap/shard_map, and is
written to be numerically identical to the reference math wherever the
reference is well-defined (zero norms map to zero directions, exactly as the
reference's ``normalize`` guard does).
"""
from __future__ import annotations

import jax.numpy as jnp

TWO_PI = 2.0 * jnp.pi


def split_xy(v):
    """``(x, y)`` planes of ``v``: a pass-through for an (x, y) tuple, the
    column split of an ``(..., 2)`` array.  The planar-interface convention:
    functions on the hot path accept either form and compute on planes
    (see models/state.py)."""
    if isinstance(v, (tuple, list)):
        x, y = v
        return x, y
    return v[..., 0], v[..., 1]


def stack_xy(x, y):
    """Assemble an ``(..., 2)`` array from x/y planes (host-side views,
    record assembly -- never inside the per-step hot path)."""
    return jnp.stack([x, y], axis=-1)


def norm(v, axis=-1):
    """Euclidean norm along ``axis`` (no zero guard)."""
    return jnp.sqrt(jnp.sum(v * v, axis=axis))


def normalize(v, axis=-1):
    """Zero-safe normalize.

    Returns ``(unit_vectors, norms)``; vectors with zero norm yield a zero
    direction and a zero norm (reference: stateutils.py:78-92 replaces zero
    norms with 1 before dividing).

    Gradient-safe: the zero guard is applied to the *squared* norm before
    the sqrt, so reverse-mode AD through zero vectors stays finite (a
    ``sqrt``-then-``where`` form produces ``0 * inf = NaN`` in the sqrt
    VJP at exactly-zero inputs).  The forward values are bitwise unchanged
    (``sqrt(n2) == n`` wherever ``n2 > 0``).  The returned *norm* keeps the
    standard sqrt derivative (infinite at 0), like ``jnp.linalg.norm``.
    """
    n2 = jnp.sum(v * v, axis=axis)
    safe = jnp.sqrt(jnp.where(n2 == 0.0, 1.0, n2))
    return v / jnp.expand_dims(safe, axis), jnp.sqrt(n2)


def cap_velocity(v, max_speed):
    """Scale velocity vectors down so their speed does not exceed ``max_speed``.

    Mirrors reference stateutils.py:18-23 (zero speeds are guarded with 1 so
    zero vectors pass through unchanged).  Gradient-safe at zero velocity
    (guard before the sqrt; see :func:`normalize`).
    """
    s2 = jnp.sum(v * v, axis=-1)
    safe = jnp.sqrt(jnp.where(s2 == 0.0, 1.0, s2))
    factor = jnp.minimum(1.0, max_speed / safe)
    return v * jnp.expand_dims(factor, -1)


def norm_xy(x, y):
    """Euclidean norm of planar components (no zero guard)."""
    return jnp.sqrt(x * x + y * y)


def normalize_xy(x, y):
    """Zero-safe planar normalize: ``(ux, uy, norm)`` with zero vectors
    mapping to zero directions (same guard — and the same gradient-safe
    guard-before-sqrt form — as :func:`normalize`)."""
    n2 = x * x + y * y
    inv = jnp.sqrt(jnp.where(n2 == 0.0, 1.0, n2))
    return x / inv, y / inv, jnp.sqrt(n2)


def cap_velocity_xy(vx, vy, max_speed):
    """Planar :func:`cap_velocity` (same math on x/y planes)."""
    s2 = vx * vx + vy * vy
    safe = jnp.sqrt(jnp.where(s2 == 0.0, 1.0, s2))
    factor = jnp.minimum(1.0, max_speed / safe)
    return vx * factor, vy * factor


def left_normal(t):
    """Normal of 2-D vectors ``t`` rotated to the left: (x, y) -> (-y, x).

    Reference: forces.py:89-91.
    """
    return jnp.stack([-t[..., 1], t[..., 0]], axis=-1)


def wrap_angle(a):
    """Wrap angles to (-pi, pi] the way the reference does (single wrap).

    Reference stateutils.py:108-112 subtracts/adds 2*pi once for values just
    outside +-pi; since inputs here are differences of two atan2 results the
    difference is always within (-2*pi, 2*pi), so one wrap suffices.
    """
    a = jnp.where(a > jnp.pi, a - TWO_PI, a)
    a = jnp.where(a < -jnp.pi, a + TWO_PI, a)
    return a


def angle_diff_2d(vecs1, vecs2):
    """Signed angle(vecs1) - angle(vecs2) wrapped to [-pi, pi].

    Matches reference stateutils.py:95-128 (two atan2 calls + wrap).
    """
    a1 = jnp.arctan2(vecs1[..., 1], vecs1[..., 0])
    a2 = jnp.arctan2(vecs2[..., 1], vecs2[..., 0])
    return wrap_angle(a1 - a2)


def signed_angle(a, b):
    """Signed angle from ``b`` to ``a`` via a single atan2.

    Mathematically identical to :func:`angle_diff_2d` (up to fp rounding):
    atan2(cross(b, a), dot(a, b)).  Used by fused kernels where the two-atan2
    form would cost an extra transcendental.
    """
    cross = b[..., 0] * a[..., 1] - b[..., 1] * a[..., 0]
    dot = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
    return jnp.arctan2(cross, dot)

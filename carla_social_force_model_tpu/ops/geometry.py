"""Geometry kernels: segmented closest points and 2-D segment intersection.

``closest_point_per_segment`` is the vectorized replacement for the
reference's per-pedestrian Python loops that take *one* closest point per
border/obstacle and then sum force contributions over borders/obstacles
(/root/reference/forces.py:154-155, :228-229).  It is exact (direct
coordinate differences, no |x|^2-2xy expansion) and memory-bounded via a
``lax.map`` over chunk groups.

``segment_intersection`` is the branchless jnp replacement for the Shapely
calls in the reference's gap-acceptance check (check_traffic.py:30-48).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..env.pointsets import PAD_COORD, ChunkedPointSet

_INF = jnp.inf
# numpy (not jnp) scalar: a module-level jnp constant would initialize the
# device backend at import time, before a CLI --platform override can apply
_BIG_I32 = np.int32(2**31 - 1)
_PAD = float(PAD_COORD)
#: squared-distance threshold separating real hits from padding sentinels
_PAD_DIST2 = 1e13


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def closest_point_per_segment(pos, pset: ChunkedPointSet,
                              max_group_elems: int = 4_000_000):
    """Per (segment, pedestrian) closest outline point.

    Args:
      pos: ``(N, 2)`` pedestrian positions.
      pset: chunked point set with ``S`` segments.
      max_group_elems: cap on ``chunk_group_points * N`` to bound the
        intermediate ``(G, K, N)`` distance tensor.

    Returns:
      ``(dist, point, has_point)`` with shapes ``(S, N)``, ``(S, N, 2)``,
      ``(S, N)``; ``has_point`` is False where a segment has no valid points.
      Tie-breaking is the reference's first-occurrence ``argmin``.
    """
    n = pos.shape[0]
    c, k, _ = pset.points.shape
    s = pset.num_segments

    # chunks per lax.map group, bounded by the (G, K, N) intermediate
    g = max(1, min(c, max_group_elems // max(1, k * n)))
    c_pad = _round_up(c, g)

    pts = jnp.concatenate(
        [pset.points, jnp.zeros((c_pad - c, k, 2), pset.points.dtype)], axis=0)
    val = jnp.concatenate(
        [pset.valid, jnp.zeros((c_pad - c, k), bool)], axis=0)
    pts_g = pts.reshape(c_pad // g, g, k, 2)
    val_g = val.reshape(c_pad // g, g, k)

    px, py = pos[:, 0], pos[:, 1]

    def per_group(args):
        p_g, v_g = args  # (G, K, 2), (G, K)
        # separate coordinate planes keep N in the minor (lane) dimension --
        # a (..., 2)-minor layout pads 2 -> 128 lanes and is ~10x slower
        dx = p_g[:, :, 0, None] - px[None, None, :]               # (G, K, N)
        dy = p_g[:, :, 1, None] - py[None, None, :]
        d2 = dx * dx + dy * dy
        d2 = jnp.where(v_g[:, :, None], d2, _INF)
        idx = jnp.argmin(d2, axis=1)                              # (G, N) first-occurrence
        dmin2 = jnp.take_along_axis(d2, idx[:, None, :], axis=1)[:, 0, :]
        best = jnp.take_along_axis(p_g, idx[:, :, None], axis=1)  # (G, N, 2)
        return dmin2, best

    if c_pad // g > 1:
        dmin2, best = jax.lax.map(per_group, (pts_g, val_g))
        dmin2 = dmin2.reshape(c_pad, n)[:c]
        best = best.reshape(c_pad, n, 2)[:c]
    else:
        dmin2, best = per_group((pts_g[0], val_g[0]))
        dmin2, best = dmin2[:c], best[:c]

    # segmented min over chunks -> per-segment min (dummy segment S absorbs nothing
    # here since every chunk has a real segment id; +1 guards empty sets)
    seg = pset.chunk_segment
    dseg2 = jax.ops.segment_min(dmin2, seg, num_segments=s)        # (S, N)

    # first chunk attaining the per-segment min (reference argmin tie rule)
    chunk_idx = jnp.arange(c, dtype=jnp.int32)[:, None]
    cand = jnp.where(dmin2 == dseg2[seg], chunk_idx, _BIG_I32)
    first_chunk = jax.ops.segment_min(cand, seg, num_segments=s)   # (S, N)
    has_point = jnp.isfinite(dseg2) & (first_chunk < _BIG_I32)
    first_chunk = jnp.clip(first_chunk, 0, max(c - 1, 0))
    point = jnp.take_along_axis(best, first_chunk[:, :, None], axis=0)  # (S, N, 2)

    dist = jnp.sqrt(jnp.where(has_point, dseg2, 0.0))
    return dist, point, has_point


def closest_point_per_chunk(pos_x, pos_y, pset: ChunkedPointSet,
                            neigh_dist: float):
    """Per (chunk, pedestrian) squared distance + closest-point planes.

    The sampled part of the ORCA static-constraint feed
    (ops/orca._static_constraints).  Unlike
    :func:`closest_point_per_segment` -- which serves the reference's
    per-*segment* argmin semantics (forces.py:154-155) -- the velocity
    projection only needs *k nearest distinct wall features*, and one
    128-point chunk (a 12.8 m wall stretch at the reference's 0.1 m
    sampling) is a finer feature than a <=30 m segment.  Staying at chunk
    granularity with planar outputs avoids the (S, N)-row gather of
    closest-point coordinates and the (S, N, 2) tensor of the segment path.

    Returns ``(d2, wx, wy)``: (C, N) f32 planes; ``d2 = inf`` where the
    chunk has no valid point within ``neigh_dist`` of the pedestrian.
    """
    n = pos_x.shape[0]
    c, k, _ = pset.points.shape
    nd2 = jnp.float32(neigh_dist) ** 2
    # grouped per-chunk min + first-occurrence selection
    px, py = pos_x, pos_y
    vx = jnp.where(pset.valid, pset.points[..., 0], _PAD)
    vy = jnp.where(pset.valid, pset.points[..., 1], _PAD)
    g = max(1, min(c, 4_000_000 // max(1, k * n)))
    c_pad = _round_up(c, g)
    vx = jnp.concatenate([vx, jnp.full((c_pad - c, k), _PAD, vx.dtype)])
    vy = jnp.concatenate([vy, jnp.full((c_pad - c, k), _PAD, vy.dtype)])

    def per_group(args):
        gx, gy = args                                     # (G, K)
        dx = gx[:, :, None] - px[None, None, :]           # (G, K, N)
        dy = gy[:, :, None] - py[None, None, :]
        d2g = dx * dx + dy * dy
        idx = jnp.argmin(d2g, axis=1)                     # (G, N)
        dmin = jnp.take_along_axis(d2g, idx[:, None, :], axis=1)[:, 0]
        bx = jnp.take_along_axis(gx[:, :, None],
                                 idx[:, None, :], axis=1)[:, 0]
        by = jnp.take_along_axis(gy[:, :, None],
                                 idx[:, None, :], axis=1)[:, 0]
        return dmin, bx, by

    vx_g = vx.reshape(c_pad // g, g, k)
    vy_g = vy.reshape(c_pad // g, g, k)
    if c_pad // g > 1:
        dmin, bx, by = jax.lax.map(per_group, (vx_g, vy_g))
        d2 = dmin.reshape(c_pad, n)[:c]
        wx = bx.reshape(c_pad, n)[:c]
        wy = by.reshape(c_pad, n)[:c]
    else:
        d2, wx, wy = per_group((vx_g[0], vy_g[0]))
        d2, wx, wy = d2[:c], wx[:c], wy[:c]

    d2 = jnp.where(d2 <= nd2, d2, _INF)
    return d2, wx, wy


def feature_closest_planes(pos_x, pos_y, feat, neigh_dist: float,
                           max_group_elems: int = 4_000_000):
    """Per (segment-feature, pedestrian) squared distance + exact closest
    point ON the segment (the analytic ORCA static feed;
    env/pointsets.SegmentFeatures).

    Planar throughout: ``(F, N)`` outputs with N minor, grouped over
    feature blocks by ``lax.map`` to bound the intermediates.  ``d2 = inf``
    where the feature is farther than ``neigh_dist``.
    """
    f = feat.ax.shape[0]
    n = pos_x.shape[0]
    nd2 = jnp.float32(neigh_dist) ** 2
    g = max(1, min(f, max_group_elems // max(1, n)))
    f_pad = _round_up(f, g)

    def pad(a, fill):
        return jnp.concatenate(
            [a.astype(jnp.float32),
             jnp.full((f_pad - f,), jnp.float32(fill))])

    ax, ay = pad(feat.ax, _PAD), pad(feat.ay, _PAD)
    ux, uy, il2 = pad(feat.ux, 0.0), pad(feat.uy, 0.0), pad(feat.il2, 0.0)

    def per_group(planes):
        gax, gay, gux, guy, gil2 = planes                 # (G,)
        dxa = pos_x[None, :] - gax[:, None]               # (G, N)
        dya = pos_y[None, :] - gay[:, None]
        t = jnp.clip((dxa * gux[:, None] + dya * guy[:, None])
                     * gil2[:, None], 0.0, 1.0)
        cx = gax[:, None] + t * gux[:, None]
        cy = gay[:, None] + t * guy[:, None]
        ddx = pos_x[None, :] - cx
        ddy = pos_y[None, :] - cy
        return ddx * ddx + ddy * ddy, cx, cy

    grouped = tuple(v.reshape(f_pad // g, g) for v in (ax, ay, ux, uy, il2))
    if f_pad // g > 1:
        d2, wx, wy = jax.lax.map(per_group, grouped)
        d2 = d2.reshape(f_pad, n)[:f]
        wx = wx.reshape(f_pad, n)[:f]
        wy = wy.reshape(f_pad, n)[:f]
    else:
        d2, wx, wy = per_group(tuple(v[0] for v in grouped))
        d2, wx, wy = d2[:f], wx[:f], wy[:f]
    return jnp.where(d2 <= nd2, d2, _INF), wx, wy


def k_smallest_features(d2, planes, k: int):
    """K masked min-extraction passes over the LEADING feature axis.

    The feature-major twin of ops/orca._k_nearest: inputs ``(F, N)`` with
    pedestrians minor, so no (N, F) transpose of the big planes ever
    materializes and every reduction runs over the leading axis.  ``d2`` uses
    ``inf`` for invalid; payload ``planes`` must be finite.  Returns
    ``(sel_planes, valid)`` with shapes ``(k, N)``, selection ascending
    with first-occurrence (lowest feature index) tie-breaking.
    """
    outs = [[] for _ in planes]
    valids = []
    for _ in range(k):
        mn = jnp.min(d2, axis=0)                        # (N,)
        hit = (d2 == mn[None, :]) & jnp.isfinite(mn)[None, :]
        first = hit & (jnp.cumsum(hit, axis=0) == 1)
        fsel = first.astype(planes[0].dtype)
        for out, pl_ in zip(outs, planes):
            out.append(jnp.sum(pl_ * fsel, axis=0))
        valids.append(jnp.any(first, axis=0))
        d2 = jnp.where(first, _INF, d2)
    sel = tuple(jnp.stack(o, axis=0) for o in outs)
    return sel, jnp.stack(valids, axis=0)


def nearest_features_topk(pos_x, pos_y, src, k: int, neigh_dist):
    """The ``k`` nearest static wall features of each pedestrian.

    ``src``: a SegmentFeatures (analytic line segments) or ChunkedPointSet
    (sampled chunks; feature = one 128-point chunk's closest point).
    Returns ``(d2, wx, wy)`` planes of shape ``(k, N)``, distances
    ascending, ``d2 = inf`` marking empty slots (fewer than k features
    within ``neigh_dist``).  Materializes the (F, N) planes and reduces
    them with :func:`k_smallest_features` (first-occurrence tie-breaking).
    """
    from ..env.pointsets import SegmentFeatures
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if isinstance(src, SegmentFeatures):
        d2, wx, wy = feature_closest_planes(pos_x, pos_y, src, neigh_dist)
    else:
        d2, wx, wy = closest_point_per_chunk(pos_x, pos_y, src, neigh_dist)
    dfin = jnp.where(jnp.isfinite(d2), d2, 0.0)
    (swx, swy, sd2), valid = k_smallest_features(d2, (wx, wy, dfin), k)
    return jnp.where(valid, sd2, jnp.inf), swx, swy


def section_closest_point(pos_x, pos_y, sset,
                          max_group_elems: int = 4_000_000):
    """Per (section, pedestrian) closest point of a section-major set.

    ``sset`` is a SegmentPointSet (first-occurrence argmin over each
    section's sampled points -- the reference's ``np.argmin``,
    forces.py:154-155) or a SegmentGeomSet (the analytic tier: clamped
    projection onto each section's Douglas-Peucker line segments,
    first-occurrence over segments).  The plain-jnp twin of the fused
    environment kernel's closest-point pass (ops/pallas_env._closest).

    Returns ``(d2, cx, cy)``, each ``(S, N)``; padding slots sit at
    PAD_COORD, so ``d2 >= _PAD_DIST2`` marks sections with no point.
    """
    from ..env.pointsets import SegmentGeomSet
    analytic = isinstance(sset, SegmentGeomSet)
    if analytic:
        planes = [(sset.ax, _PAD), (sset.ay, _PAD), (sset.ux, 0.0),
                  (sset.uy, 0.0), (sset.inv_len2, 0.0)]
    else:
        planes = [(sset.points[..., 0], _PAD), (sset.points[..., 1], _PAD)]
    s, k = planes[0][0].shape
    n = pos_x.shape[0]
    g = max(1, min(s, max_group_elems // max(1, k * n)))
    s_pad = _round_up(s, g)
    planes = [jnp.concatenate([p.astype(jnp.float32),
                               jnp.full((s_pad - s, k), fill, jnp.float32)])
              .reshape(s_pad // g, g, k) for p, fill in planes]

    def per_group(grp):
        if analytic:
            ax, ay, ux, uy, il2 = (p[:, :, None] for p in grp)
            t = jnp.clip(((pos_x - ax) * ux + (pos_y - ay) * uy) * il2,
                         0.0, 1.0)
            cx = ax + t * ux                                # (G, K, N)
            cy = ay + t * uy
        else:
            cx, cy = (p[:, :, None] for p in grp)           # (G, K, 1)
        ddx = pos_x - cx
        ddy = pos_y - cy
        d2 = ddx * ddx + ddy * ddy                          # (G, K, N)
        idx = jnp.argmin(d2, axis=1)[:, None, :]            # first occurrence
        pick = lambda a: jnp.take_along_axis(  # noqa: E731
            jnp.broadcast_to(a, d2.shape), idx, axis=1)[:, 0, :]
        return pick(d2), pick(cx), pick(cy)

    if s_pad // g > 1:
        d2, cx, cy = jax.lax.map(per_group, planes)
    else:
        d2, cx, cy = (a[None] for a in per_group([p[0] for p in planes]))
    return tuple(a.reshape(s_pad, n)[:s] for a in (d2, cx, cy))


def segment_filter_mask(pos, pset: ChunkedPointSet):
    """Coarse per-(segment, ped) relevance filter: ``|pos - center| < radius``.

    Matches the reference's border section filter (forces.py:149-151) and the
    obstacle perception filter (forces.py:222-224), both strict ``<``.
    (Planar coordinate math with N in the minor dimension and a squared
    comparison -- sqrt(x) < r <=> x < r*r for r >= 0.)
    """
    dx = pset.centers[:, 0, None] - pos[None, :, 0]            # (S, N)
    dy = pset.centers[:, 1, None] - pos[None, :, 1]
    d2 = dx * dx + dy * dy
    r = jnp.maximum(pset.filter_radius, 0.0)
    return d2 < (r * r)[:, None]


def segment_intersection_xy(p0x, p0y, p1x, p1y, q0x, q0y, q1x, q1y,
                            eps: float = 0.0):
    """Planar :func:`segment_intersection` (same math on x/y planes --
    the hot-path form: no size-2-minor intermediates).

    Returns ``(hit, ipx, ipy)`` with intersection coordinates zeroed when
    there is no hit."""
    rx, ry = p1x - p0x, p1y - p0y
    sx, sy = q1x - q0x, q1y - q0y
    denom = rx * sy - ry * sx
    qpx, qpy = q0x - p0x, q0y - p0y
    t_num = qpx * sy - qpy * sx
    u_num = qpx * ry - qpy * rx
    safe = jnp.where(denom == 0.0, 1.0, denom)
    t = t_num / safe
    u = u_num / safe
    hit = ((denom != 0.0) & (t >= -eps) & (t <= 1.0 + eps)
           & (u >= -eps) & (u <= 1.0 + eps))
    zero = jnp.zeros((), t.dtype)
    ipx = jnp.where(hit, p0x + t * rx, zero)
    ipy = jnp.where(hit, p0y + t * ry, zero)
    return hit, ipx, ipy


def segment_intersection(p0, p1, q0, q1, eps: float = 0.0):
    """Intersection of 2-D segments ``[p0, p1]`` and ``[q0, q1]`` (batched).

    Returns ``(hit, point)``: ``hit`` is True for a proper (non-parallel)
    intersection with both parameters in ``[0, 1]``; ``point`` is the
    intersection location (zeros when no hit).  Collinear-overlap cases are
    reported as no hit (the reference delegates these to Shapely where they
    are measure-zero; documented deviation).
    """
    r = p1 - p0
    s = q1 - q0
    denom = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q0 - p0
    t_num = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    u_num = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    safe = jnp.where(denom == 0.0, 1.0, denom)
    t = t_num / safe
    u = u_num / safe
    hit = (denom != 0.0) & (t >= -eps) & (t <= 1.0 + eps) & (u >= -eps) & (u <= 1.0 + eps)
    point = p0 + jnp.expand_dims(t, -1) * r
    return hit, jnp.where(jnp.expand_dims(hit, -1), point, 0.0)

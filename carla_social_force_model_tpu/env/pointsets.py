"""Padded, chunked point-cloud containers for borders and obstacles.

The reference stores borders/obstacle outlines as ragged Python lists of
numpy arrays and loops over pedestrians (forces.py:145-155, :217-229).  The
device layout packs *all* points of all segments (a segment = one border
or one obstacle outline) into a dense ``(num_chunks, chunk_size, 2)`` array
with a per-chunk segment id.  Ragged segment lengths are handled by splitting
each segment into fixed-size chunks and padding the tail; a segmented min
over chunks recovers the exact per-segment closest point (ops/geometry.py).

Tie-breaking matches the reference's ``np.argmin`` first-occurrence rule
because chunks preserve point order.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass, static_field

#: coordinate written into padding slots (never the nearest point)
PAD_COORD = 1.0e8


@pytree_dataclass
class ChunkedPointSet:
    """A set of ``num_segments`` point-sampled outlines, chunked for the
    vectorized closest-point passes.

    ``centers``/``filter_radius`` drive the reference's coarse relevance
    filters: for sidewalk borders the section center/length pair
    (forces.py:149-151), for obstacles the center + perception threshold
    (forces.py:222-224).
    """

    points: jnp.ndarray        # (C, K, 2) f32, padded with PAD_COORD
    valid: jnp.ndarray         # (C, K) bool
    chunk_segment: jnp.ndarray  # (C,) int32 segment id per chunk
    centers: jnp.ndarray       # (S, 2) per-segment filter center
    filter_radius: jnp.ndarray  # (S,) per-segment filter radius
    num_segments: int = static_field()

    @property
    def num_chunks(self) -> int:
        return self.points.shape[0]

    @property
    def chunk_size(self) -> int:
        return self.points.shape[1]


@pytree_dataclass
class SegmentPointSet:
    """Segment-major point layout: one fixed-size row per segment.

    The fused environment-force kernels (ops/pallas_env.py) compute the
    per-segment closest point *and* the force inside one kernel, which
    requires each segment's points to be contiguous and uniformly sized:
    ``points[s]`` holds all sampled points of segment ``s`` padded with
    ``PAD_COORD`` to a common ``K`` (multiple of 128).  Unlike
    :class:`ChunkedPointSet` there is no chunk/segment indirection, so no
    segmented reduction or gather is ever needed downstream.
    """

    points: jnp.ndarray        # (S, K, 2) f32, PAD_COORD in padding slots
    centers: jnp.ndarray       # (S, 2) per-segment filter center
    filter_radius: jnp.ndarray  # (S,) per-segment filter radius
    num_segments: int = static_field()

    @property
    def points_per_segment(self) -> int:
        return self.points.shape[1]


def segment_major(pset: ChunkedPointSet | None,
                  max_points_per_segment: int = 4096
                  ) -> SegmentPointSet | None:
    """Repack a (host-side, concrete) :class:`ChunkedPointSet` into the
    segment-major layout, or None when a segment is too long (callers fall
    back to the chunked closest-point path) or the set is empty.

    Must run outside jit (concrete arrays); Scene builders call this once
    per scenario via models.stepper.prepare_scene.
    """
    if pset is None:
        return None
    s_count = pset.num_segments
    k_chunk = pset.chunk_size
    per_seg = _per_segment_points(pset)
    longest = max((p.shape[0] for p in per_seg), default=0)
    if longest == 0 or longest > max_points_per_segment:
        return None
    k = -(-max(longest, 1) // k_chunk) * k_chunk
    out = np.full((s_count, k, 2), PAD_COORD,
                  np.asarray(pset.points).dtype)
    for si, p in enumerate(per_seg):
        out[si, : p.shape[0]] = p
    return SegmentPointSet(
        points=jnp.asarray(out),
        centers=pset.centers,
        filter_radius=pset.filter_radius,
        num_segments=s_count,
    )


@pytree_dataclass
class SegmentGeomSet:
    """Analytic per-section line-segment geometry (the ``env_analytic``
    tier, ops/pallas_env.py).

    The reference approximates each border section by 0.1 m-sampled points
    and takes ``np.argmin`` over them (obstacles.py sampling;
    forces.py:154-155) -- the sampled argmin is therefore itself a
    quantization of the true wall geometry.  This container instead stores
    each section as up to ``M`` line segments (Douglas-Peucker-simplified
    vertices of the same polyline), and the analytic kernels compute the
    exact closest point ON the segments: ~kk/M times less work per
    (section, pedestrian) pair (kk = sampled points per section, typically
    512; M typically 8), and *more* faithful to the underlying geometry
    than the sampled path.  Padding segments carry ``ax = PAD_COORD`` and
    ``ux = inv_len2 = 0`` so their closest point is the PAD sentinel
    (masked by distance); degenerate single-point sections are segments
    with ``ux = uy = 0`` whose closest point is the point itself.
    """

    ax: jnp.ndarray            # (S, M) f32 segment start x
    ay: jnp.ndarray            # (S, M)
    ux: jnp.ndarray            # (S, M) segment vector (b - a) x
    uy: jnp.ndarray            # (S, M)
    inv_len2: jnp.ndarray      # (S, M) 1 / |u|^2 (0 for degenerate/padding)
    centers: jnp.ndarray       # (S, 2) per-segment filter center
    filter_radius: jnp.ndarray  # (S,) per-segment filter radius
    num_segments: int = static_field()

    @property
    def max_segments(self) -> int:
        return self.ax.shape[1]


@pytree_dataclass
class SegmentFeatures:
    """Flat line-segment wall features (the ORCA static-constraint feed).

    Unlike :class:`SegmentGeomSet` -- whose (S, M) per-*section* layout
    serves the border force's one-closest-point-per-section semantics
    (/root/reference/forces.py:154-155) -- the ORCA velocity projection
    wants the ``k`` nearest *distinct wall features*, and the natural
    feature of a Douglas-Peucker-simplified polyline is the individual
    line segment: a straight 30 m wall is ONE feature (one exact
    half-plane) instead of three 12.8 m point chunks whose collinear
    constraints waste projection slots, while a within-section corner is
    TWO features whose two half-planes box the corner exactly.  So the
    segment-feature feed is both finer at corners and coarser along
    straights than the chunk feed it replaces -- and its closest points
    are exact instead of 0.1 m-sample-quantized.

    ``ccx``/``ccy``/``rad`` are per-feature filter circles (segment
    midpoint + half-length; inflate by the neighbor distance at use time)
    driving the kernel tile skip.  Single-point features (degenerate
    sections) carry ``ux = uy = il2 = 0`` and ``rad = 0``.
    """

    ax: jnp.ndarray        # (F,) f32 segment start x
    ay: jnp.ndarray        # (F,)
    ux: jnp.ndarray        # (F,) segment vector (b - a) x
    uy: jnp.ndarray        # (F,)
    il2: jnp.ndarray       # (F,) 1 / |u|^2 (0 for degenerate points)
    ccx: jnp.ndarray       # (F,) filter-circle center x
    ccy: jnp.ndarray       # (F,)
    rad: jnp.ndarray       # (F,) filter-circle radius (uninflated)
    num_features: int = static_field()


@pytree_dataclass
class StaticFeatures:
    """A point set split into analytic segment features + sampled remainder
    (the ORCA static-constraint sources; built by
    :func:`build_static_features`).  ``seg`` holds every section that
    simplifies safely (straight/gently-bent walls); ``rest`` keeps the
    original chunked sampling for everything else (tight curves,
    multi-piece sections) so the feed never *loses* geometry."""

    seg: SegmentFeatures | None = None
    rest: ChunkedPointSet | None = None


def segment_features(gset: SegmentGeomSet | None) -> SegmentFeatures | None:
    """Flatten a per-section :class:`SegmentGeomSet` into flat
    :class:`SegmentFeatures` (host-side, concrete arrays)."""
    if gset is None:
        return None
    ax = np.asarray(gset.ax, np.float32).reshape(-1)
    ay = np.asarray(gset.ay, np.float32).reshape(-1)
    ux = np.asarray(gset.ux, np.float32).reshape(-1)
    uy = np.asarray(gset.uy, np.float32).reshape(-1)
    il2 = np.asarray(gset.inv_len2, np.float32).reshape(-1)
    real = ax < PAD_COORD / 2          # padding rows carry ax = PAD_COORD
    if not real.any():
        return None
    ax, ay, ux, uy, il2 = (v[real] for v in (ax, ay, ux, uy, il2))
    return SegmentFeatures(
        ax=jnp.asarray(ax), ay=jnp.asarray(ay),
        ux=jnp.asarray(ux), uy=jnp.asarray(uy), il2=jnp.asarray(il2),
        ccx=jnp.asarray(ax + 0.5 * ux), ccy=jnp.asarray(ay + 0.5 * uy),
        rad=jnp.asarray(0.5 * np.sqrt(ux * ux + uy * uy)),
        num_features=int(ax.shape[0]))


def build_static_features(pset: ChunkedPointSet | None, tol: float = 1e-3,
                          max_segments: int = 8) -> StaticFeatures | None:
    """Build the ORCA static-feature split of a point set (host-side).

    Runs :func:`analytic_split` (same safety gates: consecutive-gap and
    chain-coverage checks route unsafe sections to the sampled remainder)
    and flattens the analytic part to :class:`SegmentFeatures`."""
    if pset is None:
        return None
    gset, rest = analytic_split(pset, tol=tol, max_segments=max_segments)
    seg = segment_features(gset)
    if seg is None and rest is None:
        return StaticFeatures(seg=None, rest=pset)
    return StaticFeatures(seg=seg, rest=rest)


def _douglas_peucker(pts: np.ndarray, tol: float) -> np.ndarray:
    """Indices of the Douglas-Peucker-simplified vertices of a polyline.

    Iterative (stack-based); keeps the first and last point and every point
    whose perpendicular distance to the current chord exceeds ``tol``.
    """
    n = pts.shape[0]
    keep = np.zeros((n,), dtype=bool)
    keep[0] = keep[n - 1] = True
    stack = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if j <= i + 1:
            continue
        a, b = pts[i], pts[j]
        u = b - a
        seg = pts[i + 1: j] - a
        len2 = float(u @ u)
        if len2 == 0.0:
            d2 = np.einsum("ij,ij->i", seg, seg)
        else:
            cross = seg[:, 0] * u[1] - seg[:, 1] * u[0]
            d2 = cross * cross / len2
        k = int(np.argmax(d2))
        if d2[k] > tol * tol:
            m = i + 1 + k
            keep[m] = True
            stack.append((i, m))
            stack.append((m, j))
    return np.flatnonzero(keep)


def _per_segment_points(pset: ChunkedPointSet) -> list[np.ndarray]:
    """Reassemble each segment's valid points in original order (host-side;
    shared by :func:`segment_major` and :func:`analytic_split`)."""
    pts = np.asarray(pset.points)
    valid = np.asarray(pset.valid)
    seg = np.asarray(pset.chunk_segment)
    per_seg: list[np.ndarray] = [np.zeros((0, 2), pts.dtype)
                                 for _ in range(pset.num_segments)]
    for c in range(pts.shape[0]):
        v = valid[c]
        if v.any():
            per_seg[seg[c]] = np.concatenate([per_seg[seg[c]], pts[c][v]],
                                             axis=0)
    return per_seg


def _chain_covers(p: np.ndarray, verts: np.ndarray, tol: float) -> bool:
    """Is every point of ``p`` within ``tol`` of the polyline ``verts``
    (distance to the SEGMENTS, not their infinite lines)?  Douglas-Peucker
    only bounds the distance to chord *lines*, so a collinear out-and-back
    section ([(0,0)..(10,0),(10,0)..(5,0)] simplifies to (0,0)-(5,0))
    passes DP but leaves sampled points far from the simplified chain --
    this check routes such sections back to the sampled path."""
    a, b = verts[:-1], verts[1:]
    u = b - a                                                # (M, 2)
    l2 = np.einsum("ij,ij->i", u, u)
    d = p[:, None, :] - a[None, :, :]                        # (P, M, 2)
    t = np.clip(np.einsum("pmi,mi->pm", d, u)
                / np.where(l2 > 0, l2, 1.0), 0.0, 1.0)
    c = a[None] + t[..., None] * u[None]
    d2 = np.sum((p[:, None, :] - c) ** 2, axis=-1)
    return bool(np.sqrt(d2.min(axis=1)).max() <= tol)


def analytic_split(pset: ChunkedPointSet | None, tol: float = 1e-3,
                   max_segments: int = 8,
                   ) -> tuple[SegmentGeomSet | None, ChunkedPointSet | None]:
    """Split a point set into (analytic geometry, sampled remainder).

    Sections whose sampled points form a connected polyline AND
    Douglas-Peucker-simplify (at ``tol`` meters) to at most
    ``max_segments`` line segments move to a :class:`SegmentGeomSet`; the
    rest stay sampled -- tightly curved outlines where simplification buys
    nothing (0.1 m-sampled ellipses), and any section where the polyline
    assumption is unsafe.  Safety gates (sections are POINT CLOUDS under
    the reference's argmin semantics, with no connectivity contract):

    * consecutive-gap check: a jump between consecutive points larger than
      4x the median spacing (min 0.5 m) means the section is multi-piece
      or reordered -- a DP chord across the jump would fabricate a phantom
      wall the sampled argmin never produces;
    * coverage check (:func:`_chain_covers`): every sampled point must lie
      within ``tol`` of the simplified chain's *segments* (DP only bounds
      distance to chord lines, which misses out-and-back overlaps).

    The environment force is a sum over sections, so evaluating the two
    sets separately and adding is exact (up to f32 summation grouping).
    Host-side, like :func:`segment_major`.
    """
    if pset is None:
        return None, None
    centers = np.asarray(pset.centers)
    radius = np.asarray(pset.filter_radius)
    per_seg = _per_segment_points(pset)

    geom: list[tuple[int, np.ndarray]] = []   # (section, (V, 2) vertices)
    rest: list[int] = []
    for si, p in enumerate(per_seg):
        if p.shape[0] == 0:
            continue
        if p.shape[0] == 1:
            geom.append((si, p))
            continue
        p64 = p.astype(np.float64)
        gaps = np.sqrt(np.sum(np.diff(p64, axis=0) ** 2, axis=1))
        if gaps.max() > max(4.0 * float(np.median(gaps)), 0.5):
            rest.append(si)
            continue
        idx = _douglas_peucker(p64, tol)
        if (idx.shape[0] - 1 <= max_segments
                and _chain_covers(p64, p64[idx], max(tol, 1e-6))):
            geom.append((si, p[idx]))
        else:
            rest.append(si)

    gset = None
    if geom:
        m = max(1, max(v.shape[0] - 1 for _, v in geom))
        m = -(-m // 8) * 8                     # padded to a multiple of 8
        s_g = len(geom)
        ax = np.full((s_g, m), PAD_COORD, np.float32)
        ay = np.full((s_g, m), PAD_COORD, np.float32)
        ux = np.zeros((s_g, m), np.float32)
        uy = np.zeros((s_g, m), np.float32)
        il2 = np.zeros((s_g, m), np.float32)
        c_g = np.zeros((s_g, 2), np.float32)
        r_g = np.zeros((s_g,), np.float32)
        for row, (si, v) in enumerate(geom):
            nv = v.shape[0]
            if nv == 1:                        # single-point section
                ax[row, 0], ay[row, 0] = v[0]
            else:
                a, b = v[:-1], v[1:]
                u = b - a
                l2 = np.einsum("ij,ij->i", u, u)
                ax[row, : nv - 1] = a[:, 0]
                ay[row, : nv - 1] = a[:, 1]
                ux[row, : nv - 1] = u[:, 0]
                uy[row, : nv - 1] = u[:, 1]
                il2[row, : nv - 1] = np.where(l2 > 0.0, 1.0 / np.maximum(
                    l2, 1e-30), 0.0)
            c_g[row] = centers[si]
            r_g[row] = radius[si]
        gset = SegmentGeomSet(
            ax=jnp.asarray(ax), ay=jnp.asarray(ay), ux=jnp.asarray(ux),
            uy=jnp.asarray(uy), inv_len2=jnp.asarray(il2),
            centers=jnp.asarray(c_g), filter_radius=jnp.asarray(r_g),
            num_segments=s_g)

    rset = None
    if rest:
        rset = build_chunked_pointset(
            [per_seg[si] for si in rest], centers[rest], radius[rest],
            chunk_size=pset.chunk_size)
    return gset, rset


def build_chunked_pointset(
    point_lists: Sequence[np.ndarray],
    centers: np.ndarray,
    filter_radius: np.ndarray,
    chunk_size: int = 128,
    dtype=np.float32,
) -> ChunkedPointSet:
    """Pack ragged per-segment point arrays into a :class:`ChunkedPointSet`.

    ``point_lists[s]`` is an ``(P_s, 2)`` array of sampled outline points of
    segment ``s`` (may be empty).  Point order within a segment is preserved
    so closest-point tie-breaking matches the reference's ``np.argmin``.
    """
    num_segments = len(point_lists)
    chunks = []
    valids = []
    seg_ids = []
    for s, pts in enumerate(point_lists):
        pts = np.asarray(pts, dtype=dtype).reshape(-1, 2)
        n = pts.shape[0]
        if n == 0:
            continue
        n_chunks = -(-n // chunk_size)
        padded = np.full((n_chunks * chunk_size, 2), PAD_COORD, dtype=dtype)
        padded[:n] = pts
        v = np.zeros((n_chunks * chunk_size,), dtype=bool)
        v[:n] = True
        chunks.append(padded.reshape(n_chunks, chunk_size, 2))
        valids.append(v.reshape(n_chunks, chunk_size))
        seg_ids.append(np.full((n_chunks,), s, dtype=np.int32))

    if chunks:
        points = np.concatenate(chunks, axis=0)
        valid = np.concatenate(valids, axis=0)
        chunk_segment = np.concatenate(seg_ids, axis=0)
    else:
        points = np.full((1, chunk_size, 2), PAD_COORD, dtype=dtype)
        valid = np.zeros((1, chunk_size), dtype=bool)
        chunk_segment = np.zeros((1,), dtype=np.int32)
        num_segments = max(num_segments, 1)

    centers = np.asarray(centers, dtype=dtype).reshape(-1, 2)
    filter_radius = np.asarray(filter_radius, dtype=dtype).reshape(-1)
    if centers.shape[0] != num_segments or filter_radius.shape[0] != num_segments:
        # pad filter metadata for empty sets
        c = np.zeros((num_segments, 2), dtype=dtype)
        r = np.zeros((num_segments,), dtype=dtype)
        c[: centers.shape[0]] = centers
        r[: filter_radius.shape[0]] = filter_radius
        centers, filter_radius = c, r

    return ChunkedPointSet(
        points=jnp.asarray(points),
        valid=jnp.asarray(valid),
        chunk_segment=jnp.asarray(chunk_segment),
        centers=jnp.asarray(centers),
        filter_radius=jnp.asarray(filter_radius),
        num_segments=num_segments,
    )

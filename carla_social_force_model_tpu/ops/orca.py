"""ORCA (Optimal Reciprocal Collision Avoidance) as a vectorized velocity law.

A fourth pedestrian-model family beyond the reference's surface (the
reference, /root/reference/forces.py, is force-based only): instead of
adding a repulsive force, ORCA (van den Berg, Guy, Lin, Manocha,
"Reciprocal n-body collision avoidance", ISRR 2011) projects each agent's
*preferred* velocity onto the intersection of half-planes of velocities
that provably avoid collisions with every neighbor for a time horizon tau,
assuming the neighbor reciprocates (each party takes half the correction).

The classic CPU implementation (RVO2) is a kd-tree neighbor query plus a
sequential randomized 2-D linear program per agent -- per-agent dynamic
control flow that maps terribly to SIMD hardware.  This implementation is
vectorized over all agents instead:

* **Neighbor selection** rides the same Hilbert-curve locality sort the
  cutoff force kernels use (ops/spatial.py): candidates are a +-W/2 window
  of the sorted order, materialized with ``jnp.roll`` (vector shifts -- no
  per-row gathers), and the K nearest are
  extracted by K masked min-reduction passes.  Exact for any crowd whose
  true K-nearest live within the sorted window (always true for
  ``window >= N``); an approximation knob, not a semantics change,
  otherwise -- identical in spirit to RVO2's own ``maxNeighbors``
  truncation.
* **The 2-D LP is solved exactly by candidate enumeration** instead of a
  sequential solve: the optimum of ``min |v - v_pref|`` over an
  intersection of C half-planes and the speed disc lies at ``v_pref``, at
  a projection of ``v_pref`` onto one constraint line, at a line-line
  intersection, or at a line-circle intersection -- a static O(C^2)
  candidate set evaluated branchlessly for all agents at once (C =
  max_neighbors + max_vehicles is ~14, so ~130 candidates/agent of pure
  elementwise math).
* **The infeasible fallback is the exact minimax program** (RVO2's
  ``linearProgram3``): maximize the least signed clearance ``m(v) =
  min_k (v - p_k) . n_k`` over the speed disc -- a concave piecewise-
  linear maximization whose optimum lies at a constraint-pair tie point,
  a tie-line/circle intersection, or a single constraint's disc argmax;
  again a static candidate set.  It runs under one ``lax.cond`` per step,
  so crowds that never saturate pay nothing.

Agents reciprocate (each takes u/2); vehicles do not (the walker takes the
full correction -- a car will not yield), mirroring how the reference's
dynamic-obstacle force treats vehicles as non-negotiating obstacles
(/root/reference/forces.py:233-270).  Static geometry (borders, parked
obstacles) enters as hard half-planes against the nearest wall features
(:func:`_static_constraints`), covering the role of the reference's border
force (forces.py:138-179) with a guarantee instead of a soft repulsion.

Everything is plain jnp on x/y coordinate planes (models/state.py): the
arithmetic is a few hundred flops per agent per step, far below the
pairwise force kernels.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .spatial import morton_sort

# feasibility slack [m/s]: half-plane clearances down to -_TOL count as
# satisfied (f32 candidate arithmetic noise, NOT a behavioral knob)
_TOL = 1e-4
# minimum |determinant| for a line-line intersection to count (near-parallel
# constraint pairs produce no useful vertex)
_DET_EPS = 1e-9


def _safe_unit(x, y, fallback_x=1.0):
    """Zero-safe unit vector: (0, 0) maps to (fallback_x, 0).

    Differentiation-safe (the whole ORCA path must be: api/calibrate.py
    fits ``orca.tau`` through it): ``sqrt`` never sees 0, because its VJP
    divides by the primal output and would turn even a ZERO incoming
    cotangent into 0/0 = NaN on masked rows.
    """
    n2 = x * x + y * y
    bad = n2 <= 0.0
    safe = jnp.where(bad, 1.0, n2)
    inv = jax.lax.rsqrt(safe)
    return (jnp.where(bad, fallback_x, x * inv),
            jnp.where(bad, 0.0, y * inv),
            jnp.where(bad, 0.0, jnp.sqrt(safe)))


def orca_halfplane(px, py, rvx, rvy, r, tau, dt):
    """The ORCA half-plane of one (agent, neighbor) pair, broadcast over
    any leading shape.

    Inputs are the pair's RELATIVE state: ``p`` = neighbor position minus
    agent position, ``rv`` = agent velocity minus neighbor velocity (the
    relative velocity whose velocity obstacle is tested), ``r`` = summed
    radii.  ``tau`` is the avoidance horizon for non-colliding pairs; pairs
    already in collision resolve over one step ``dt`` instead (the standard
    construction).

    Returns ``(ux, uy, nx, ny)``: ``u`` is the smallest change of the
    relative velocity that puts it on the boundary of the truncated
    velocity obstacle ``VO^tau``, and ``n`` the obstacle's outward unit
    normal at that boundary point.  The agent's half-plane constraint is
    ``(v - (v_agent + zeta * u)) . n >= 0`` with ``zeta`` the share of the
    correction this agent takes (1/2 reciprocating, 1 against vehicles).

    Geometry (the ISRR-2011 construction, derived independently):
    ``VO^tau`` is the union of the disc ``D(p/tau, r/tau)`` and the cone
    from the origin tangent to ``D(p, r)``, truncated at the disc.  The
    closest boundary point to ``rv`` lies on the truncation arc when
    ``w = rv - p/tau`` points backward of the tangent points
    (``w.p < 0`` and ``(w.p)^2 > r^2 |w|^2``), else on one of the tangent
    legs (side chosen by ``sign(cross(p, w))``).
    """
    d2 = px * px + py * py
    r2 = r * r
    colliding = d2 <= r2

    # ---- non-colliding: truncated cone with horizon tau ----------------
    inv_tau = 1.0 / tau
    wx = rvx - px * inv_tau
    wy = rvy - py * inv_tau
    w2 = wx * wx + wy * wy
    dot1 = wx * px + wy * py
    on_arc = (dot1 < 0.0) & (dot1 * dot1 > r2 * w2)

    uwx, uwy, wlen = _safe_unit(wx, wy)
    arc_ux = (r * inv_tau - wlen) * uwx
    arc_uy = (r * inv_tau - wlen) * uwy

    # tangent legs: rotate p by the half-angle whose sin is r/|p|;
    # guard d2 <= r2 (leg length imaginary) -- those rows take the
    # colliding branch anyway
    safe_d2 = jnp.where(colliding, 1.0, d2)
    # colliding rows would put 0 under the sqrt (NaN-poisoning the VJP,
    # see _safe_unit); they take the colliding branch, so feed 1 instead
    leg = jnp.sqrt(jnp.where(colliding, 1.0, jnp.maximum(d2 - r2, 0.0)))
    left_side = (px * wy - py * wx) > 0.0
    # left leg (counter-clockwise tangent) / right leg (clockwise)
    ldx = jnp.where(left_side, px * leg - py * r, px * leg + py * r) / safe_d2
    ldy = jnp.where(left_side, px * r + py * leg, py * leg - px * r) / safe_d2
    t_on = rvx * ldx + rvy * ldy
    leg_ux = t_on * ldx - rvx
    leg_uy = t_on * ldy - rvy
    # outward normal: left leg -> rotate leg dir +90deg, right leg -> -90deg
    leg_nx = jnp.where(left_side, -ldy, ldy)
    leg_ny = jnp.where(left_side, ldx, -ldx)

    nc_ux = jnp.where(on_arc, arc_ux, leg_ux)
    nc_uy = jnp.where(on_arc, arc_uy, leg_uy)
    nc_nx = jnp.where(on_arc, uwx, leg_nx)
    nc_ny = jnp.where(on_arc, uwy, leg_ny)

    # ---- colliding: push out of D(p/dt, r/dt) over one step ------------
    inv_dt = 1.0 / dt
    cwx = rvx - px * inv_dt
    cwy = rvy - py * inv_dt
    cux, cuy, cwlen = _safe_unit(cwx, cwy)
    c_ux = (r * inv_dt - cwlen) * cux
    c_uy = (r * inv_dt - cwlen) * cuy

    ux = jnp.where(colliding, c_ux, nc_ux)
    uy = jnp.where(colliding, c_uy, nc_uy)
    nx = jnp.where(colliding, cux, nc_nx)
    ny = jnp.where(colliding, cuy, nc_ny)
    return ux, uy, nx, ny


def _pair_indices(c: int):
    """Static upper-triangle index pair (numpy, trace-time)."""
    iu, ju = np.triu_indices(c, k=1)
    return iu.astype(np.int32), ju.astype(np.int32)


def solve_lp2(pref_x, pref_y, ptx, pty, nx, ny, valid, vmax):
    """Exact 2-D LP by candidate enumeration, vectorized over rows.

    minimize ``|v - pref|`` subject to ``(v - pt_k) . n_k >= 0`` for every
    valid constraint and ``|v| <= vmax``.

    Shapes: ``pref_*``/``vmax`` (...,), constraints (..., C).  Returns
    ``(vx, vy, feasible)``; rows with an empty feasible region get their
    best-scoring candidate anyway (callers refine them with
    :func:`solve_lp3` under a ``lax.cond``).
    """
    C = ptx.shape[-1]
    b = ptx * nx + pty * ny          # line offsets: n . v == b on boundary

    cands_x, cands_y, cands_ok = [], [], []

    def add(cx, cy, ok):
        cands_x.append(jnp.where(ok, cx, 0.0))
        cands_y.append(jnp.where(ok, cy, 0.0))
        cands_ok.append(ok)

    # 1. preferred velocity, clipped into the speed disc
    p2 = pref_x * pref_x + pref_y * pref_y
    scale = jnp.minimum(1.0, vmax * jax.lax.rsqrt(jnp.where(p2 == 0, 1.0, p2)))
    add((pref_x * scale)[..., None], (pref_y * scale)[..., None],
        jnp.ones(ptx.shape[:-1] + (1,), bool))

    # 2. projection of pref onto each constraint line (optimum when one
    #    constraint is active), valid while inside the disc
    s = b - (pref_x[..., None] * nx + pref_y[..., None] * ny)
    qx = pref_x[..., None] + s * nx
    qy = pref_y[..., None] + s * ny
    add(qx, qy, valid & (qx * qx + qy * qy <= (vmax * vmax)[..., None]))

    # 3. line/speed-circle intersections (optimum when a line and the disc
    #    are both active).  Line points: pt + t * d, d = perp(n).
    dx, dy = -ny, nx
    pd = ptx * dx + pty * dy
    disc = pd * pd - (ptx * ptx + pty * pty) + (vmax * vmax)[..., None]
    ok_c = valid & (disc >= 0.0)
    # no 0 under the sqrt on invalid rows (NaN-poisoning VJP, _safe_unit)
    root = jnp.sqrt(jnp.where(ok_c, jnp.maximum(disc, 0.0), 1.0))
    for sgn in (-1.0, 1.0):
        t = -pd + sgn * root
        add(ptx + t * dx, pty + t * dy, ok_c)

    # 4. constraint-pair intersections (optimum at a vertex of two lines)
    if C >= 2:
        iu, ju = _pair_indices(C)
        n1x, n1y, b1 = nx[..., iu], ny[..., iu], b[..., iu]
        n2x, n2y, b2 = nx[..., ju], ny[..., ju], b[..., ju]
        det = n1x * n2y - n1y * n2x
        ok_p = valid[..., iu] & valid[..., ju] & (jnp.abs(det) > _DET_EPS)
        safe = jnp.where(ok_p, det, 1.0)
        add((b1 * n2y - b2 * n1y) / safe, (n1x * b2 - n2x * b1) / safe, ok_p)

    cx = jnp.concatenate(cands_x, axis=-1)      # (..., Ncand)
    cy = jnp.concatenate(cands_y, axis=-1)
    ok = jnp.concatenate(cands_ok, axis=-1)

    # feasibility: min signed clearance over valid constraints >= -tol,
    # inside the (slightly slackened) speed disc
    clear = ((cx[..., :, None] - ptx[..., None, :]) * nx[..., None, :]
             + (cy[..., :, None] - pty[..., None, :]) * ny[..., None, :])
    min_clear = jnp.min(jnp.where(valid[..., None, :], clear, jnp.inf),
                        axis=-1)
    in_disc = cx * cx + cy * cy <= (vmax * vmax)[..., None] * (1.0 + 4e-6) \
        + _TOL
    feas = ok & (min_clear >= -_TOL) & in_disc

    score = ((cx - pref_x[..., None]) ** 2 + (cy - pref_y[..., None]) ** 2)
    score = jnp.where(feas, score, jnp.inf)
    best = jnp.min(score, axis=-1, keepdims=True)
    hit = (score == best) & feas
    first = hit & (jnp.cumsum(hit, axis=-1) == 1)
    fsel = first.astype(cx.dtype)
    vx = jnp.sum(cx * fsel, axis=-1)
    vy = jnp.sum(cy * fsel, axis=-1)
    feasible = jnp.any(feas, axis=-1)
    return vx, vy, feasible


def solve_lp3(ptx, pty, nx, ny, valid, vmax):
    """Exact minimax fallback for rows whose half-plane intersection is
    empty: maximize ``m(v) = min_k (v - pt_k) . n_k`` over ``|v| <= vmax``
    (the least-penetration velocity; RVO2's ``linearProgram3`` objective).

    ``m`` is concave piecewise-linear, so the maximum over the disc lies
    at a tie point of three constraints, on a two-constraint tie line's
    circle intersection, or at a single constraint's disc argmax
    ``vmax * n_k`` -- all enumerated statically.

    Returns ``(vx, vy)``.
    """
    C = ptx.shape[-1]
    b = ptx * nx + pty * ny

    cands_x, cands_y, cands_ok = [], [], []

    def add(cx, cy, ok):
        # clamp candidates into the disc (tie-line vertices can fall
        # outside; their in-disc projection along the tie line is covered
        # by the circle-intersection candidates, so plain invalidation is
        # also fine -- clamping just recovers a few near-misses)
        c2 = cx * cx + cy * cy
        sc = jnp.minimum(1.0, vmax[..., None]
                         * jax.lax.rsqrt(jnp.where(c2 == 0, 1.0, c2)))
        cands_x.append(jnp.where(ok, cx * sc, 0.0))
        cands_y.append(jnp.where(ok, cy * sc, 0.0))
        cands_ok.append(ok)

    # single-constraint argmax over the disc
    add(vmax[..., None] * nx, vmax[..., None] * ny, valid)

    if C >= 2:
        iu, ju = _pair_indices(C)
        # tie line of constraints (i, j): (n_i - n_j) . v = b_i - b_j
        tx = nx[..., iu] - nx[..., ju]
        ty = ny[..., iu] - ny[..., ju]
        tb = b[..., iu] - b[..., ju]
        t2 = tx * tx + ty * ty
        ok_t = valid[..., iu] & valid[..., ju] & (t2 > _DET_EPS)
        safe_t2 = jnp.where(ok_t, t2, 1.0)
        # closest point of the tie line to the origin + circle hits
        px0 = tx * tb / safe_t2
        py0 = ty * tb / safe_t2
        ddx, ddy = -ty, tx
        h2 = (vmax * vmax)[..., None] - (px0 * px0 + py0 * py0)
        ok_c = ok_t & (h2 >= 0.0)
        h = (jnp.sqrt(jnp.where(ok_c, jnp.maximum(h2, 0.0), 1.0))
             * jax.lax.rsqrt(safe_t2))
        for sgn in (-1.0, 1.0):
            add(px0 + sgn * h * ddx, py0 + sgn * h * ddy, ok_c)

        if C >= 3:
            # three-way ties: solve g_i = g_j, g_j = g_k (2x2)
            ii, jj, kk = (np.stack(v).astype(np.int32) for v in
                          zip(*[(a, bb, c) for a in range(C)
                                for bb in range(a + 1, C)
                                for c in range(bb + 1, C)]))
            a1x = nx[..., ii] - nx[..., jj]
            a1y = ny[..., ii] - ny[..., jj]
            c1 = b[..., ii] - b[..., jj]
            a2x = nx[..., jj] - nx[..., kk]
            a2y = ny[..., jj] - ny[..., kk]
            c2_ = b[..., jj] - b[..., kk]
            det = a1x * a2y - a1y * a2x
            ok3 = (valid[..., ii] & valid[..., jj] & valid[..., kk]
                   & (jnp.abs(det) > _DET_EPS))
            safe = jnp.where(ok3, det, 1.0)
            add((c1 * a2y - c2_ * a1y) / safe, (a1x * c2_ - a2x * c1) / safe,
                ok3)

    cx = jnp.concatenate(cands_x, axis=-1)
    cy = jnp.concatenate(cands_y, axis=-1)
    ok = jnp.concatenate(cands_ok, axis=-1)

    clear = ((cx[..., :, None] - ptx[..., None, :]) * nx[..., None, :]
             + (cy[..., :, None] - pty[..., None, :]) * ny[..., None, :])
    m = jnp.min(jnp.where(valid[..., None, :], clear, jnp.inf), axis=-1)
    m = jnp.where(ok, m, -jnp.inf)
    best = jnp.max(m, axis=-1, keepdims=True)
    hit = (m == best) & ok
    first = hit & (jnp.cumsum(hit, axis=-1) == 1)
    fsel = first.astype(cx.dtype)
    return jnp.sum(cx * fsel, axis=-1), jnp.sum(cy * fsel, axis=-1)


def solve_orca_lp(pref_x, pref_y, ptx, pty, nx, ny, valid, vmax):
    """LP2 with the exact minimax fallback on infeasible rows (the
    fallback's candidate sweep runs under one ``lax.cond``, so it costs
    nothing on steps where every agent's program is feasible)."""
    vx, vy, feasible = solve_lp2(pref_x, pref_y, ptx, pty, nx, ny, valid,
                                 vmax)

    def with_lp3(_):
        fx, fy = solve_lp3(ptx, pty, nx, ny, valid, vmax)
        return jnp.where(feasible, vx, fx), jnp.where(feasible, vy, fy)

    return jax.lax.cond(jnp.all(feasible), lambda _: (vx, vy), with_lp3,
                        operand=None)


def _k_nearest(d2, planes, k):
    """K masked min-extraction passes over the candidate axis (gather-free:
    first-occurrence one-hot reductions instead of row gathers).

    ``d2``: (..., W) candidate distances (inf = invalid); ``planes``: tuple
    of (..., W) attribute planes.  Returns ``(sel_planes, valid)`` with
    shapes (..., k).
    """
    outs = [[] for _ in planes]
    valids = []
    for _ in range(k):
        mn = jnp.min(d2, axis=-1, keepdims=True)
        hit = (d2 == mn) & jnp.isfinite(mn)
        first = hit & (jnp.cumsum(hit, axis=-1) == 1)
        fsel = first.astype(planes[0].dtype)
        for out, pl in zip(outs, planes):
            out.append(jnp.sum(pl * fsel, axis=-1))
        valids.append(jnp.any(first, axis=-1))
        d2 = jnp.where(first, jnp.inf, d2)
    sel = tuple(jnp.stack(o, axis=-1) for o in outs)
    return sel, jnp.stack(valids, axis=-1)


def _window_neighbors(sx, sy, svx, svy, sr, salive, window, k, neigh_dist):
    """K nearest alive neighbors out of a +-window/2 band of the sorted
    order, built with ``jnp.roll`` shifts (vector ops, no gathers).

    Inputs are SORTED planes (...,N).  Returns (..., N, k) neighbor planes
    ``(nx, ny, nvx, nvy, nr)`` and a validity mask.
    """
    half = window // 2
    offs = [o for o in range(-half, half + 1) if o != 0]
    cand = {"x": [], "y": [], "vx": [], "vy": [], "r": [], "a": []}
    for o in offs:
        cand["x"].append(jnp.roll(sx, -o, axis=-1))
        cand["y"].append(jnp.roll(sy, -o, axis=-1))
        cand["vx"].append(jnp.roll(svx, -o, axis=-1))
        cand["vy"].append(jnp.roll(svy, -o, axis=-1))
        cand["r"].append(jnp.roll(sr, -o, axis=-1))
        cand["a"].append(jnp.roll(salive, -o, axis=-1))
    st = {kk: jnp.stack(v, axis=-1) for kk, v in cand.items()}  # (...,N,W)
    dx = st["x"] - sx[..., None]
    dy = st["y"] - sy[..., None]
    d2 = dx * dx + dy * dy
    ok = st["a"] & (d2 <= neigh_dist * neigh_dist) & salive[..., None]
    d2 = jnp.where(ok, d2, jnp.inf)
    (nx_, ny_, nvx, nvy, nr), valid = _k_nearest(
        d2, (st["x"], st["y"], st["vx"], st["vy"], st["r"]), k)
    return nx_, ny_, nvx, nvy, nr, valid


def _full_neighbors(px, py, vx, vy, radius, alive, k, neigh_dist):
    """Exact K-nearest over the full N x N distance matrix (small N)."""
    dx = px[..., None, :] - px[..., :, None]
    dy = py[..., None, :] - py[..., :, None]
    d2 = dx * dx + dy * dy
    n = px.shape[-1]
    eye = jnp.eye(n, dtype=bool)
    ok = (alive[..., None, :] & alive[..., :, None] & ~eye
          & (d2 <= neigh_dist * neigh_dist))
    d2 = jnp.where(ok, d2, jnp.inf)
    bx = jnp.broadcast_to(px[..., None, :], d2.shape)
    by = jnp.broadcast_to(py[..., None, :], d2.shape)
    bvx = jnp.broadcast_to(vx[..., None, :], d2.shape)
    bvy = jnp.broadcast_to(vy[..., None, :], d2.shape)
    br = jnp.broadcast_to(radius[..., None, :], d2.shape)
    (nx_, ny_, nvx, nvy, nr), valid = _k_nearest(
        d2, (bx, by, bvx, bvy, br), k)
    return nx_, ny_, nvx, nvy, nr, valid


def _vehicle_constraints(ex, ey, evx, evy, er, veh_snap, k, neigh_dist,
                         tau, dt):
    """ORCA half-planes against the ``k`` nearest active vehicles, as
    bounding discs (circumscribed circle of the vehicle's extent box; the
    walker takes the FULL correction -- vehicles do not reciprocate).

    Ego planes (..., N); vehicle snapshot arrays (V, ...).  Returns
    constraint planes (..., N, k) + validity.
    """
    cvx, cvy = veh_snap.center[..., 0], veh_snap.center[..., 1]
    vvx, vvy = veh_snap.vel[..., 0], veh_snap.vel[..., 1]
    vr = jnp.sqrt(veh_snap.extent[..., 0] ** 2
                  + veh_snap.extent[..., 1] ** 2)
    act = veh_snap.active.astype(bool)

    dx = cvx - ex[..., None]            # (..., N, V)
    dy = cvy - ey[..., None]
    d2 = dx * dx + dy * dy
    ok = act & (d2 <= neigh_dist * neigh_dist)
    d2 = jnp.where(ok, d2, jnp.inf)
    shp = d2.shape
    (sx, sy, svx, svy, sr), valid = _k_nearest(
        d2, tuple(jnp.broadcast_to(a, shp)
                  for a in (cvx, cvy, vvx, vvy, vr)), min(k, cvx.shape[-1]))
    ux, uy, nx_, ny_ = orca_halfplane(
        sx - ex[..., None], sy - ey[..., None],
        evx[..., None] - svx, evy[..., None] - svy,
        er[..., None] + sr, tau, dt)
    # full responsibility: plane passes through v_ego + u
    ptx = evx[..., None] + ux
    pty = evy[..., None] + uy
    return ptx, pty, nx_, ny_, valid


def _static_topk(ex, ey, src, k, neigh_dist):
    """(k, N) nearest-wall-feature planes ``(d2, wx, wy)`` (``d2 = inf``
    marking empty slots) from one static source.

    ``src`` is a ChunkedPointSet (features = 128-point chunks) or a
    StaticFeatures split (env/pointsets.build_static_features): analytic
    Douglas-Peucker segment features for every wall section that
    simplifies safely, plus the chunked sampling of the rest.  When both
    parts exist, each contributes its own top-k and a (2k, N) merge picks
    the overall k -- exact, since a feature lives in exactly one part.
    """
    from ..env.pointsets import StaticFeatures
    from .geometry import k_smallest_features, nearest_features_topk
    if isinstance(src, StaticFeatures):
        parts = []
        if src.seg is not None:
            parts.append(nearest_features_topk(ex, ey, src.seg, k,
                                               neigh_dist))
        if src.rest is not None:
            parts.append(nearest_features_topk(ex, ey, src.rest, k,
                                               neigh_dist))
        if not parts:
            n = ex.shape[-1]
            z = jnp.zeros((k, n), ex.dtype)
            return jnp.full((k, n), jnp.inf, ex.dtype), z, z
        if len(parts) == 1:
            return parts[0]
        d2 = jnp.concatenate([p[0] for p in parts], axis=0)
        wx = jnp.concatenate([p[1] for p in parts], axis=0)
        wy = jnp.concatenate([p[2] for p in parts], axis=0)
        dfin = jnp.where(jnp.isfinite(d2), d2, 0.0)
        (swx, swy, sd2), valid = k_smallest_features(d2, (wx, wy, dfin), k)
        return jnp.where(valid, sd2, jnp.inf), swx, swy
    return nearest_features_topk(ex, ey, src, k, neigh_dist)


def _static_constraints(ex, ey, er, exempt, src, k, tau_static, dt,
                        neigh_dist):
    """Half-plane constraints against the ``k`` nearest static wall
    features (the same wall geometry the reference's border force reduces
    over, /root/reference/forces.py:138-179 -- but as HARD constraints on
    the velocity program instead of a soft exponential force).

    For a straight wall at body gap ``g = d - r`` the set of velocities
    that stay clear for ``tau_static`` seconds is exactly
    ``{v : v . n >= -g / tau_static}`` with ``n`` the unit normal away
    from the wall: the wall-ward speed may never exceed the gap over the
    horizon, so (unlike a soft force, which crowd pressure can overpower)
    the projection can never select a wall-crossing velocity.  Penetrating
    rows (``g < 0``, e.g. a spawn inside geometry) get the one-step
    push-out plane ``v . n >= -g / dt`` instead -- the same collision
    resolution the pair half-planes use.

    A *feature* is an analytic Douglas-Peucker wall segment where the
    section simplifies safely (exact closest point, one feature per
    straight wall however long -- so collinear constraints never waste
    projection slots) and a 128-point chunk (12.8 m at the reference's
    0.1 m sampling) elsewhere; see :func:`_static_topk`.  Corners are
    covered by the ``k`` nearest *distinct* features: a within-section
    corner is two analytic segments whose two half-planes box it exactly
    (finer than the chunk feed's accidental 12.8 m cuts).

    ``exempt`` rows (road-crossing modes -- they must step over the curb
    border, mirroring the border force's crossing-mode deactivation,
    forces.py:176-177) produce no constraints.

    Ego planes ``(N,)``; returns constraint planes ``(N, k)`` plus
    validity (batch via vmap).
    """
    sd2, swx, swy = _static_topk(ex, ey, src, k, neigh_dist)
    valid = jnp.isfinite(sd2) & ~exempt[None, :]               # (k, N)
    sd = jnp.where(valid, jnp.sqrt(jnp.where(valid, sd2, 1.0)), 0.0)
    nx, ny, _ = _safe_unit(ex[None, :] - swx, ey[None, :] - swy)
    gap = sd - er[None, :]
    horizon = jnp.where(gap >= 0.0, tau_static, dt)
    rhs = -gap / horizon            # constraint: v . n >= rhs
    # (k, N) -> (N, k): tiny planes, the LP's constraint-minor layout
    t = lambda a: jnp.swapaxes(a, -2, -1)  # noqa: E731
    return t(rhs * nx), t(rhs * ny), t(nx), t(ny), t(valid)


def orca_velocities(pos, vel, radius, alive, pref, vmax, params, dt,
                    veh_snap=None, axis_name=None,
                    spatial_order: str = "hilbert",
                    borders=None, obstacles=None, static_exempt=None):
    """New velocities for every agent under ORCA.

    ``pos``/``vel``/``pref``: (x, y) plane tuples (N,); ``radius``/``vmax``
    (N,); ``alive`` (N,) bool.  ``pref`` is the agent's preferred velocity
    -- here the force-integrated, capped velocity of the surrounding SFM
    pipeline, so goal seeking and wall repulsion shape the preference and
    ORCA guarantees the collision-avoidance projection on top (a hybrid
    richer than classic goal-directed ORCA; with only the acceleration
    force enabled it reduces to the classic form up to the relaxation).

    ``borders`` / ``obstacles`` (optional -- a ChunkedPointSet, or the
    faster analytic StaticFeatures split built by
    env/pointsets.build_static_features) add HARD half-plane constraints
    against the ``params.max_statics`` nearest
    static wall features each (:func:`_static_constraints`) -- the
    projection then provably cannot pick a wall-crossing velocity, a
    guarantee the reference's soft border force cannot give under crowd
    pressure.  ``static_exempt`` (bool (N,), optional) marks rows the wall
    constraints skip -- road-crossing modes, which must step over curb
    borders (the border force's own crossing-mode deactivation rule).
    When the full program is infeasible the minimax fallback relaxes all
    constraints jointly, walls included (RVO2 keeps obstacle lines hard in
    its fallback; with walls-only programs always feasible -- ``v = 0``
    satisfies every wall plane with non-negative gap -- the difference
    only matters for agents simultaneously crushed by neighbors AND walls).

    Under agent-sharding (``axis_name``), the planes are all-gathered and
    every device computes its local rows from the global crowd (the same
    global-view pattern as the autopilot hazard check); neighbor windows
    then span shard boundaries exactly as on one device.

    Returns (vx, vy) planes, valid where ``alive`` (dead rows undefined).
    """
    px, py = pos
    vx, vy = vel
    prx, pry = pref
    use_statics = ((borders is not None or obstacles is not None)
                   and params.max_statics > 0)
    exm = (static_exempt if static_exempt is not None
           else jnp.zeros_like(alive))

    if axis_name is not None:
        g = lambda a: jax.lax.all_gather(a, axis_name, tiled=True)  # noqa: E731
        local_n = px.shape[-1]
        px, py, vx, vy = g(px), g(py), g(vx), g(vy)
        radius, alive = g(radius), g(alive)
        prx, pry, vmax = g(prx), g(pry), g(vmax)
        exm = g(exm)

    n = px.shape[-1]
    k = params.max_neighbors
    window = params.window if params.window else n
    use_full = window >= n

    if use_full:
        nx_, ny_, nvx, nvy, nr, valid = _full_neighbors(
            px, py, vx, vy, radius, alive, k, params.neighbor_dist)
        ex, ey, evx, evy, er = px, py, vx, vy, radius
        eprx, epry, evmax, eexm = prx, pry, vmax, exm
        inv = None
    else:
        planes = (px, py, vx, vy, radius, prx, pry, vmax,
                  alive.astype(jnp.uint8), exm.astype(jnp.uint8))
        sorted_planes, inv = morton_sort((px, py), alive, planes,
                                         order=spatial_order)
        (ex, ey, evx, evy, er, eprx, epry, evmax, sa, se) = sorted_planes
        salive = sa.astype(bool)
        eexm = se.astype(bool)
        nx_, ny_, nvx, nvy, nr, valid = _window_neighbors(
            ex, ey, evx, evy, er, salive, window, k, params.neighbor_dist)

    # agent-agent half-planes (reciprocal: each takes u/2)
    ux, uy, hx, hy = orca_halfplane(
        nx_ - ex[..., None], ny_ - ey[..., None],
        evx[..., None] - nvx, evy[..., None] - nvy,
        er[..., None] + nr, params.tau, dt)
    ptx = evx[..., None] + 0.5 * ux
    pty = evy[..., None] + 0.5 * uy

    if veh_snap is not None and params.max_vehicles > 0:
        vptx, vpty, vnx, vny, vvalid = _vehicle_constraints(
            ex, ey, evx, evy, er, veh_snap, params.max_vehicles,
            params.neighbor_dist, params.tau, dt)
        ptx = jnp.concatenate([ptx, vptx], axis=-1)
        pty = jnp.concatenate([pty, vpty], axis=-1)
        hx = jnp.concatenate([hx, vnx], axis=-1)
        hy = jnp.concatenate([hy, vny], axis=-1)
        valid = jnp.concatenate([valid, vvalid], axis=-1)

    if use_statics:
        for pset in (borders, obstacles):
            if pset is None:
                continue
            sptx, spty, snx, sny, svalid = _static_constraints(
                ex, ey, er, eexm, pset, params.max_statics,
                params.tau_static, dt, params.neighbor_dist)
            ptx = jnp.concatenate([ptx, sptx], axis=-1)
            pty = jnp.concatenate([pty, spty], axis=-1)
            hx = jnp.concatenate([hx, snx], axis=-1)
            hy = jnp.concatenate([hy, sny], axis=-1)
            valid = jnp.concatenate([valid, svalid], axis=-1)

    ovx, ovy = solve_orca_lp(eprx, epry, ptx, pty, hx, hy, valid, evmax)

    if inv is not None:
        ovx, ovy = ovx[..., inv], ovy[..., inv]

    if axis_name is not None:
        idx = jax.lax.axis_index(axis_name)
        ovx = jax.lax.dynamic_slice_in_dim(ovx, idx * local_n, local_n)
        ovy = jax.lax.dynamic_slice_in_dim(ovy, idx * local_n, local_n)
    return ovx, ovy

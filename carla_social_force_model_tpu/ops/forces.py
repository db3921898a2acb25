"""Social-force kernels as pure, masked jnp functions.

Each kernel maps ``(state arrays, environment arrays, params) -> (N, 2)``
forces and is semantically equivalent to the corresponding reference force
(file:line cited per function) under the alive/pair masks that replace the
reference's dynamic row add/remove.  All kernels are shape-static, branchless
and jit/vmap/shard_map-safe; the fused Pallas variants live in
``ops/pallas_forces.py`` and are validated against these.

Where the reference divides by a vanishing interaction strength ``B``
(yielding inf/nan that numpy silently exp()s to 0 when the distance is
positive), we mask explicitly: pairs with ``B == 0`` contribute zero force,
which equals the reference result for all non-degenerate states (the only
divergence is two exactly-coincident pedestrians with equal velocities, where
the reference produces NaN).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import vecmath
from .geometry import (_PAD_DIST2, closest_point_per_segment,
                       section_closest_point, segment_filter_mask)
from ..env.pointsets import ChunkedPointSet
from ..models.params import (AccelerationParams, BorderParams, MoussaidParams,
                             PedRepulsiveParams, PowerLawParams,
                             SpaceRepulsiveParams)
from ..models import modes


def acceleration_force(pos, vel, waypoint, applied_target, p: AccelerationParams):
    """Relaxation toward target speed along the desired direction.

    Reference: forces.py:46-53 with desired_directions from
    stateutils.py:7-15 (zero-safe normalize of waypoint - pos).
    """
    e, _ = vecmath.normalize(waypoint - pos)
    return (applied_target[:, None] * e - vel) / p.tau


def acceleration_force_xy(pos_x, pos_y, vel_x, vel_y, wp_x, wp_y,
                          applied_target, p: AccelerationParams):
    """Planar :func:`acceleration_force` (identical math on x/y planes);
    returns ``(fx, fy)``."""
    ex, ey, _ = vecmath.normalize_xy(wp_x - pos_x, wp_y - pos_y)
    return ((applied_target * ex - vel_x) / p.tau,
            (applied_target * ey - vel_y) / p.tau)


def _moussaid_pair_force(diff, radius_sub, dv, p: MoussaidParams, pair_ok):
    """Shared Moussaid et al. (2009) interaction term.

    Args:
      diff: raw vector from the pedestrian toward the interaction partner.
      radius_sub: radii to subtract from the distance (0 when disabled).
      dv: relative velocity (pedestrian minus partner).
      pair_ok: mask of pairs that contribute.

    Returns the (…, 2) force contribution per pair.
    Reference math: forces.py:85-115 (pedestrians) and :240-270 (obstacles).
    Implementation notes (values equal to the reference formulation within
    fp rounding, enforced by the oracle-parity tests):
      * normalizations use one rsqrt instead of sqrt+divide,
      * theta = angle(e) - angle(t_hat) wrapped to [-pi, pi] is computed as
        a single atan2 of the (cross, dot) pair -- mathematically identical
        for the angle *difference* of two vectors, and the dominant
        transcendental in the N x N hot loop.
    """
    # planar (x, y) coordinate math throughout (models/state.py)
    dx = diff[..., 0]
    dy = diff[..., 1]
    dvx = dv[..., 0]
    dvy = dv[..., 1]
    d2 = dx * dx + dy * dy
    r = jax.lax.rsqrt(jnp.where(d2 == 0.0, 1.0, d2))
    ex = dx * r                                # zero-safe unit vector
    ey = dy * r
    d = d2 * r - radius_sub                    # = |diff| - radii

    tx = p.lambda_ * dvx + ex
    ty = p.lambda_ * dvy + ey
    t2 = tx * tx + ty * ty
    rt = jax.lax.rsqrt(jnp.where(t2 == 0.0, 1.0, t2))
    thx = tx * rt
    thy = ty * rt
    t_len = t2 * rt

    B = p.gamma * t_len
    # B == 0 (vanishing interaction vector) and d2 == 0 (exactly coincident
    # positions) are both NaN in the reference (0/0 unit vectors); they
    # contribute zero here (PARITY.md), which also makes the masking
    # distance-only -- exactly the fused Pallas kernel's rule.
    ok = pair_ok & (B > 0.0) & (d2 > 0.0)

    # signed angle from t_hat to e via one atan2.  Masked pairs (which
    # include every self-pair: d2 == 0) would feed (0, 0) into arctan2 --
    # fine forward (arctan2(0, 0) == 0, and the result is zeroed below) but
    # NaN in reverse mode (the arctan2 VJP divides by x^2 + y^2), so guard
    # the *inputs*: the returned force is bitwise unchanged and rollouts
    # stay differentiable (api/calibrate.py).
    cross = jnp.where(ok, thx * ey - thy * ex, 0.0)
    dot = jnp.where(ok, ex * thx + ey * thy, 1.0)
    theta = jnp.arctan2(cross, dot)
    theta = theta + B * (-p.epsilon)
    B_safe = jnp.where(ok, B, 1.0)
    common = -d / B_safe
    Bt = B * theta
    f_v = -p.A * jnp.exp(common - jnp.square(p.n_prime * Bt))
    f_t = -p.A * jnp.sign(theta) * jnp.exp(common - jnp.square(p.n * Bt))
    # f = f_v * t_hat + f_t * left_normal(t_hat)
    fx = jnp.where(ok, f_v * thx - f_t * thy, 0.0)
    fy = jnp.where(ok, f_v * thy + f_t * thx, 0.0)
    return jnp.stack([fx, fy], axis=-1)


def pedestrian_force(pos, vel, radius, alive, p: MoussaidParams,
                     use_ped_radius: bool = False, row_block: int = 1024,
                     axis_name: str | None = None, axis_comm: str = "gather"):
    """Full N x N pedestrian interaction force (reference forces.py:74-117).

    Row-blocked with ``lax.map`` so the pairwise intermediates stay
    O(row_block * N) regardless of capacity.

    Agent-sharding: under ``shard_map`` with rows sharded over mesh axis
    ``axis_name``, pass that name -- the column ("other agents") state is
    communicated between devices while each device computes only its row block of
    the N x N interaction (SURVEY.md section 2, parallelism inventory).
    ``axis_comm``:
      * ``"gather"`` -- one all-gather of the column state per step (best
        when the per-device state tile is small),
      * ``"ring"``   -- ppermute the column tile around the ring and
        accumulate partial sums (the ring-attention-shaped schedule; force
        accumulation is an exact order-free sum, so results match the
        gather path bitwise up to f32 addition order).
    """
    n_local = pos.shape[0]
    dtype = pos.dtype

    if axis_name is not None and axis_comm == "ring":
        return _pedestrian_force_ring(pos, vel, radius, alive, p,
                                      use_ped_radius, axis_name)

    if axis_name is not None:
        pos_c = jax.lax.all_gather(pos, axis_name, tiled=True)
        vel_c = jax.lax.all_gather(vel, axis_name, tiled=True)
        rad_c = jax.lax.all_gather(radius, axis_name, tiled=True)
        alive_c = jax.lax.all_gather(alive, axis_name, tiled=True)
        row_offset = jax.lax.axis_index(axis_name) * n_local
    else:
        pos_c, vel_c, rad_c, alive_c = pos, vel, radius, alive
        row_offset = 0
    n_total = pos_c.shape[0]

    def block(row_idx):
        # row_idx: (R,) local row indices (may include padding >= n_local)
        in_range = row_idx < n_local
        safe_idx = jnp.minimum(row_idx, n_local - 1)
        pos_i = pos[safe_idx]
        vel_i = vel[safe_idx]
        rad_i = radius[safe_idx]
        alive_i = alive[safe_idx] & in_range

        dx = pos_c[None, :, :] - pos_i[:, None, :]        # x_j - x_i
        dv = vel_i[:, None, :] - vel_c[None, :, :]        # v_i - v_j
        radius_sub = (rad_i[:, None] + rad_c[None, :]) if use_ped_radius else 0.0
        col = jnp.arange(n_total, dtype=row_idx.dtype)[None, :]
        not_self = (row_offset + safe_idx)[:, None] != col
        pair_ok = alive_i[:, None] & alive_c[None, :] & not_self
        f = _moussaid_pair_force(dx, radius_sub, dv, p, pair_ok)
        return jnp.sum(f, axis=1)                         # (R, 2)

    if n_local <= row_block:
        return block(jnp.arange(n_local, dtype=jnp.int32)).astype(dtype)

    n_pad = -(-n_local // row_block) * row_block
    rows = jnp.arange(n_pad, dtype=jnp.int32).reshape(-1, row_block)
    out = jax.lax.map(block, rows)                        # (n_pad/R, R, 2)
    return out.reshape(n_pad, 2)[:n_local].astype(dtype)



def _ring_force(axis_name, cols0, offset0, acc0, block_force):
    """Shared ppermute-ring schedule for the jnp pair forces.

    Rotates the column tile (``cols0`` planes plus its global slot
    ``offset0``) one hop per ring step, accumulating
    ``block_force(cols, offset)`` into ``acc0``; after D steps every
    (local row, column shard) pair has been computed exactly once.  XLA
    lowers the ppermute to an async collective permute, overlapping each
    transfer with the next block's compute.  One implementation so a
    schedule fix cannot silently miss a force family.
    """
    d = jax.lax.axis_size(axis_name)
    perm = [(i, (i + 1) % d) for i in range(d)]

    def body(carry, _):
        tile, acc = carry
        acc = acc + block_force(tile[:-1], tile[-1])
        tile = jax.lax.ppermute(tile, axis_name, perm)
        return (tile, acc), None

    (_, force), _ = jax.lax.scan(
        body, ((*cols0, offset0), acc0), None, length=d)
    return force


def _pedestrian_force_ring(pos, vel, radius, alive, p: MoussaidParams,
                           use_ped_radius: bool, axis_name: str):
    """Ring-rotated column tiles (see :func:`pedestrian_force`
    and :func:`_ring_force`)."""
    n_local = pos.shape[0]
    me = jax.lax.axis_index(axis_name)
    row_idx = me * n_local + jnp.arange(n_local, dtype=jnp.int32)

    def block_force(cols, offset):
        pos_c, vel_c, rad_c, alive_c = cols
        dx = pos_c[None, :, :] - pos[:, None, :]
        dv = vel[:, None, :] - vel_c[None, :, :]
        radius_sub = (radius[:, None] + rad_c[None, :]) if use_ped_radius else 0.0
        col_idx = offset + jnp.arange(n_local, dtype=jnp.int32)[None, :]
        pair_ok = (alive[:, None] & alive_c[None, :]
                   & (row_idx[:, None] != col_idx))
        f = _moussaid_pair_force(dx, radius_sub, dv, p, pair_ok)
        return jnp.sum(f, axis=1)

    return _ring_force(axis_name, (pos, vel, radius, alive), me * n_local,
                       jnp.zeros_like(pos), block_force)


def _powerlaw_pair_force(diff, rad_sum, dv, p: PowerLawParams, pair_ok):
    """Karamouzas et al. (2014) time-to-collision pair force.

    Args follow :func:`_moussaid_pair_force`'s conventions: ``diff`` is the
    raw vector from the pedestrian TOWARD the partner (x_j - x_i), ``dv``
    the relative velocity v_i - v_j, ``rad_sum`` the summed disc radii.

    The pair energy is E(tau) = k * tau^-2 * exp(-tau/tau0) where tau is
    the first root of |x + v*t| = R (x = x_i - x_j, v = v_i - v_j, R the
    summed radii): with a = v.v, b = x.v, c = x.x - R^2, D = b^2 - a*c,
    tau = (-b - sqrt(D)) / a.  The force on i is -grad_{x_i} E:

        F = k * exp(-tau/tau0) * (2/tau + 1/tau0) / tau^2
              * (a*x - (sqrt(D) + b)*v) / (a*sqrt(D))

    Pairs not on a collision course contribute nothing: already-overlapping
    (c <= 0), diverging or missing (D <= 0 or tau <= 0), same-velocity
    (a ~ 0), or colliding beyond the anticipation horizon (tau > tau_max).
    """
    xx = -diff[..., 0]                          # x = x_i - x_j
    xy = -diff[..., 1]
    vx = dv[..., 0]                             # v = v_i - v_j
    vy = dv[..., 1]
    a = vx * vx + vy * vy
    b = xx * vx + xy * vy
    c = xx * xx + xy * xy - rad_sum * rad_sum
    disc = b * b - a * c
    ok = pair_ok & (c > 0.0) & (disc > 0.0) & (a > 1e-8)
    disc_safe = jnp.where(ok, disc, 1.0)
    a_safe = jnp.where(ok, a, 1.0)
    s = jnp.sqrt(disc_safe)
    tau = (-b - s) / a_safe
    ok = ok & (tau > 0.0) & (tau < p.tau_max)
    tau = jnp.clip(tau, p.tau_min, p.tau_max)
    mag = (p.k * jnp.exp(-tau / p.tau0)
           * (2.0 / tau + 1.0 / p.tau0) / (tau * tau))
    scale = jnp.where(ok, mag / (a_safe * s), 0.0)
    fx = scale * (a * xx - (s + b) * vx)
    fy = scale * (a * xy - (s + b) * vy)
    return jnp.stack([fx, fy], axis=-1)


def powerlaw_force(pos, vel, radius, alive, p: PowerLawParams,
                   row_block: int = 1024, axis_name: str | None = None,
                   axis_comm: str = "gather"):
    """Full N x N Karamouzas power-law interaction (model family beyond the
    reference's Moussaid force; see :class:`PowerLawParams`).  Structure
    mirrors :func:`pedestrian_force`: row-blocked ``lax.map``, and under
    agent-sharding the column state all-gathers or ring-rotates.
    Disc radii always participate (the law is defined on discs)."""
    n_local = pos.shape[0]
    dtype = pos.dtype

    if axis_name is not None and axis_comm == "ring":
        me = jax.lax.axis_index(axis_name)

        def block_force(cols, offset):
            pos_c, vel_c, rad_c, alive_c = cols
            dxp = pos_c[None, :, :] - pos[:, None, :]
            dv = vel[:, None, :] - vel_c[None, :, :]
            rad_sum = radius[:, None] + rad_c[None, :]
            row_idx = me * n_local + jnp.arange(n_local, dtype=jnp.int32)
            col_idx = offset + jnp.arange(n_local, dtype=jnp.int32)[None, :]
            pair_ok = (alive[:, None] & alive_c[None, :]
                       & (row_idx[:, None] != col_idx))
            f = _powerlaw_pair_force(dxp, rad_sum, dv, p, pair_ok)
            return jnp.sum(f, axis=1)

        return _ring_force(axis_name, (pos, vel, radius, alive),
                           me * n_local, jnp.zeros_like(pos), block_force)

    if axis_name is not None:
        pos_c = jax.lax.all_gather(pos, axis_name, tiled=True)
        vel_c = jax.lax.all_gather(vel, axis_name, tiled=True)
        rad_c = jax.lax.all_gather(radius, axis_name, tiled=True)
        alive_c = jax.lax.all_gather(alive, axis_name, tiled=True)
        row_offset = jax.lax.axis_index(axis_name) * n_local
    else:
        pos_c, vel_c, rad_c, alive_c = pos, vel, radius, alive
        row_offset = 0
    n_total = pos_c.shape[0]

    def block(row_idx):
        in_range = row_idx < n_local
        safe_idx = jnp.minimum(row_idx, n_local - 1)
        pos_i = pos[safe_idx]
        vel_i = vel[safe_idx]
        rad_i = radius[safe_idx]
        alive_i = alive[safe_idx] & in_range

        dxp = pos_c[None, :, :] - pos_i[:, None, :]       # x_j - x_i
        dv = vel_i[:, None, :] - vel_c[None, :, :]        # v_i - v_j
        rad_sum = rad_i[:, None] + rad_c[None, :]
        col = jnp.arange(n_total, dtype=row_idx.dtype)[None, :]
        not_self = (row_offset + safe_idx)[:, None] != col
        pair_ok = alive_i[:, None] & alive_c[None, :] & not_self
        f = _powerlaw_pair_force(dxp, rad_sum, dv, p, pair_ok)
        return jnp.sum(f, axis=1)

    if n_local <= row_block:
        return block(jnp.arange(n_local, dtype=jnp.int32)).astype(dtype)
    n_pad = -(-n_local // row_block) * row_block
    rows = jnp.arange(n_pad, dtype=jnp.int32).reshape(-1, row_block)
    out = jax.lax.map(block, rows)
    return out.reshape(n_pad, 2)[:n_local].astype(dtype)


def border_force(pos, mode, radius, alive, borders: ChunkedPointSet,
                 p: BorderParams, use_ped_radius: bool = False):
    """Exponential repulsion from the nearest point of each relevant border.

    Reference: forces.py:138-179 -- per border within the section filter,
    take the single closest sampled point and add ``a*exp(-d/b)`` away from
    it; the force is disabled for pedestrians in CROSSING_ROAD /
    ROAD_TO_SIDEWALK modes (forces.py:176-177).
    """
    _, point, has_point = closest_point_per_segment(pos, borders)  # (S,N)
    in_section = segment_filter_mask(pos, borders)
    # planar math (see _moussaid_pair_force note on minor-dim-2 layouts)
    dx = pos[None, :, 0] - point[..., 0]                   # border -> ped
    dy = pos[None, :, 1] - point[..., 1]
    d2 = dx * dx + dy * dy
    r = jax.lax.rsqrt(jnp.where(d2 == 0.0, 1.0, d2))
    d = d2 * r
    if use_ped_radius:
        d = d - radius[None, :]
    ok = has_point & in_section & alive[None, :]
    mag = jnp.where(ok, (p.a * jnp.exp(-d / p.b)) * r, 0.0)
    force = jnp.stack([jnp.sum(mag * dx, axis=0),
                       jnp.sum(mag * dy, axis=0)], axis=-1)    # (N, 2)
    crossing = (mode == modes.CROSSING_ROAD) | (mode == modes.ROAD_TO_SIDEWALK)
    return jnp.where(crossing[:, None], 0.0, force)


def section_wall_force(pos_x, pos_y, mode, radius, alive, sset, a, inv_b,
                       use_ped_radius: bool = False):
    """``a * exp(-d * inv_b)`` away from each in-filter section's closest
    point, summed over sections, on a section-major set (SegmentPointSet
    or the analytic SegmentGeomSet; ops/geometry.section_closest_point).

    The border force (a, 1/b; reference forces.py:138-179) and the space
    repulsive force (u0/r, 1/r) over the layouts the fused environment
    kernel reads -- its plain-jnp twin, and the jnp path of the analytic
    border tier (``StepConfig.env_analytic``).  Returns ``(fx, fy)``
    planes; crossing modes are exempt (forces.py:176-177)."""
    d2, cx, cy = section_closest_point(pos_x, pos_y, sset)
    dx = pos_x[None, :] - cx                               # wall -> ped
    dy = pos_y[None, :] - cy
    r = jax.lax.rsqrt(jnp.where(d2 == 0.0, 1.0, d2))
    d = d2 * r
    if use_ped_radius:
        d = d - radius[None, :]
    fdx = sset.centers[:, 0, None] - pos_x[None, :]
    fdy = sset.centers[:, 1, None] - pos_y[None, :]
    fr = jnp.maximum(sset.filter_radius, 0.0)[:, None]
    ok = (fdx * fdx + fdy * fdy < fr * fr) & (d2 < _PAD_DIST2) & alive[None, :]
    mag = jnp.where(ok, (a * jnp.exp(-d * inv_b)) * r, 0.0)
    crossing = (mode == modes.CROSSING_ROAD) | (mode == modes.ROAD_TO_SIDEWALK)
    fx = jnp.where(crossing, 0.0, jnp.sum(mag * dx, axis=0))
    fy = jnp.where(crossing, 0.0, jnp.sum(mag * dy, axis=0))
    return fx, fy


def _helbing_pair_force(pos_i, e_i, pos_c, vel_c, pair_ok,
                        p: PedRepulsiveParams):
    """Helbing-Molnar (1995) elliptical pair force with FoV modulation.

    ``pos_i``/``e_i`` are (R, 2) row pedestrians (position, desired
    direction), ``pos_c``/``vel_c`` (C, 2) column partners, ``pair_ok``
    (R, C) the liveness/self mask.  V(b) = v0 * exp(-b/sigma) where 2b is
    the minor axis of the ellipse around the partner's anticipated step
    ``y = step_width * v_j``; the force on i is -grad V, weighted by
    fov_factor when j lies outside i's +-fov_phi field of view around the
    desired direction.  Note the asymmetry: the law reads v_j but never
    v_i, so unlike Moussaid/powerlaw it is NOT antisymmetric."""
    cos_phi = jnp.cos(jnp.deg2rad(p.fov_phi))
    d = pos_i[:, None, :] - pos_c[None, :, :]         # r_i - r_j
    y = p.step_width * vel_c[None, :, :]              # partner step
    dmy = d - y
    nd = vecmath.norm(d)
    ndmy = vecmath.norm(dmy)
    s = nd + ndmy
    y2 = jnp.sum(y * y, axis=-1)
    b2 = jnp.maximum(s * s - y2, 0.0) * 0.25
    b = jnp.sqrt(b2)

    ok = pair_ok & (b > 0.0) & (nd > 0.0) & (ndmy > 0.0)
    nd_s = jnp.where(nd == 0.0, 1.0, nd)
    ndmy_s = jnp.where(ndmy == 0.0, 1.0, ndmy)
    # b_min floor: b cancels to 0 for an equal-speed follower directly
    # behind its leader (s^2 - |y|^2 catastrophically), where the raw
    # s/(4b) magnitude is unbounded and f32 rounding decides between
    # "masked" and a huge kick; the clamp saturates V(b) below the contact
    # scale (see PedRepulsiveParams.b_min) and the force stays continuous
    # (grad b's two unit vectors cancel in the degenerate geometry)
    b_s = jnp.maximum(jnp.where(ok, b, 1.0), p.b_min)
    grad = (s / (4.0 * b_s))[..., None] * (d / nd_s[..., None]
                                           + dmy / ndmy_s[..., None])
    f = (p.v0 / p.sigma) * jnp.exp(-b_s / p.sigma)[..., None] * grad

    # field-of-view modulation (Helbing eq. 7): sources behind i are
    # felt weaker; -f points from i toward the source j
    toward = -f
    seen = (jnp.sum(e_i[:, None, :] * toward, axis=-1)
            >= vecmath.norm(toward) * cos_phi)
    w = jnp.where(seen, 1.0, p.fov_factor)
    return jnp.where(ok[..., None], w[..., None] * f, 0.0)


def ped_repulsive_force(pos, vel, desired_dir, alive, p: PedRepulsiveParams,
                        row_block: int = 1024, axis_name: str | None = None,
                        axis_comm: str = "gather"):
    """Helbing-Molnar (1995) elliptical pedestrian repulsion with FoV.

    A working implementation of the force class the reference's config
    names but does not ship (pedestrian_simulation.py:49-53); also a third
    pair-force model family (``law="helbing"`` on the Pallas kernel).
    Structure mirrors :func:`pedestrian_force`: row-blocked ``lax.map``,
    and under agent-sharding the column state (positions, velocities,
    liveness -- the law never reads the row pedestrian's own velocity)
    all-gathers or ring-rotates.
    """
    n_local = pos.shape[0]

    if axis_name is not None and axis_comm == "ring":
        me = jax.lax.axis_index(axis_name)

        def block_force(cols, offset):
            pos_c, vel_c, alive_c = cols
            row_idx = me * n_local + jnp.arange(n_local, dtype=jnp.int32)
            col_idx = offset + jnp.arange(n_local, dtype=jnp.int32)[None, :]
            pair_ok = (alive[:, None] & alive_c[None, :]
                       & (row_idx[:, None] != col_idx))
            f = _helbing_pair_force(pos, desired_dir, pos_c, vel_c,
                                    pair_ok, p)
            return jnp.sum(f, axis=1)

        return _ring_force(axis_name, (pos, vel, alive), me * n_local,
                           jnp.zeros_like(pos), block_force)

    if axis_name is not None:
        pos_c = jax.lax.all_gather(pos, axis_name, tiled=True)
        vel_c = jax.lax.all_gather(vel, axis_name, tiled=True)
        alive_c = jax.lax.all_gather(alive, axis_name, tiled=True)
        row_offset = jax.lax.axis_index(axis_name) * n_local
    else:
        pos_c, vel_c, alive_c = pos, vel, alive
        row_offset = 0
    n_total = pos_c.shape[0]

    def block(row_idx):
        in_range = row_idx < n_local
        safe_idx = jnp.minimum(row_idx, n_local - 1)
        col = jnp.arange(n_total, dtype=row_idx.dtype)[None, :]
        not_self = (row_offset + safe_idx)[:, None] != col
        alive_i = alive[safe_idx] & in_range
        pair_ok = alive_i[:, None] & alive_c[None, :] & not_self
        f = _helbing_pair_force(pos[safe_idx], desired_dir[safe_idx],
                                pos_c, vel_c, pair_ok, p)
        return jnp.sum(f, axis=1)

    if n_local <= row_block:
        return block(jnp.arange(n_local, dtype=jnp.int32))
    n_pad = -(-n_local // row_block) * row_block
    rows = jnp.arange(n_pad, dtype=jnp.int32).reshape(-1, row_block)
    out = jax.lax.map(block, rows)
    return out.reshape(n_pad, 2)[:n_local]


def space_repulsive_force(pos, mode, alive, borders: ChunkedPointSet,
                          p: SpaceRepulsiveParams):
    """Helbing-Molnar (1995) boundary repulsion U(d) = u0 * exp(-d/r) from
    the nearest point of each relevant border (the reference's second dead
    config path, implemented).  Shares the border force's section filter and
    crossing-mode deactivation conventions."""
    _, point, has_point = closest_point_per_segment(pos, borders)
    in_section = segment_filter_mask(pos, borders)
    dx = pos[None, :, 0] - point[..., 0]
    dy = pos[None, :, 1] - point[..., 1]
    d2 = dx * dx + dy * dy
    r = jax.lax.rsqrt(jnp.where(d2 == 0.0, 1.0, d2))
    d = d2 * r
    ok = has_point & in_section & alive[None, :]
    mag = jnp.where(ok, ((p.u0 / p.r) * jnp.exp(-d / p.r)) * r, 0.0)
    force = jnp.stack([jnp.sum(mag * dx, axis=0),
                       jnp.sum(mag * dy, axis=0)], axis=-1)
    crossing = (mode == modes.CROSSING_ROAD) | (mode == modes.ROAD_TO_SIDEWALK)
    return jnp.where(crossing[:, None], 0.0, force)


def obstacle_force(pos, vel, radius, alive, obstacles: ChunkedPointSet,
                   obstacle_vel, p: MoussaidParams,
                   use_ped_radius: bool = False, obstacle_active=None):
    """Moussaid interaction force against the closest point of each obstacle.

    Covers both the static (zero ``obstacle_vel``) and dynamic variants
    (reference forces.py:182-283; parameters differ per variant only).
    ``obstacle_active``: optional (S,) mask for obstacles that currently
    exist (despawned scripted vehicles).
    """
    _, point, has_point = closest_point_per_segment(pos, obstacles)
    percept = segment_filter_mask(pos, obstacles)
    diff = point - pos[None, :, :]                         # ped -> obstacle
    radius_sub = radius[None, :] if use_ped_radius else 0.0
    dv = vel[None, :, :] - obstacle_vel[:, None, :]        # (S, N, 2)
    ok = has_point & percept & alive[None, :]
    if obstacle_active is not None:
        ok = ok & obstacle_active[:, None]
    f = _moussaid_pair_force(diff, radius_sub, dv, p, ok)  # (S, N, 2)
    return jnp.sum(f, axis=0)

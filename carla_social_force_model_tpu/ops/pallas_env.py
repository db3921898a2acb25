"""Fused Pallas kernels (Triton route, GPU) for the environment forces.

The jnp formulation (ops/geometry.closest_point_per_segment feeding
ops/forces.border_force / obstacle_force) evaluates every (section,
pedestrian) pair: it builds a ``(G, K, N)`` distance tensor, a segmented
min and an ``(S, N, 2)`` gather of closest points.  On a street grid of
~100k wall points against 10k pedestrians that is ~1e9 distance
evaluations per step, almost all of them for sections whose coarse
relevance filter (the reference's section-center/length circle, its
forces.py:149-151, or the obstacle perception threshold, :222-224)
excludes the pedestrian anyway.

These kernels compute the per-section closest point *and* the force in
one pass and skip the excluded work exactly:

* pedestrians are sorted along a space-filling curve (ops/spatial.py) so
  each tile of pedestrians is spatially tight; one program per tile;
* an in-kernel loop walks the sections; a section runs only if its
  filter circle touches the tile's bounding box (pairs outside the circle
  contribute zero by definition, so the skip is exact);
* a section's closest point is the first-occurrence argmin over its
  sampled points (the reference's ``np.argmin``, forces.py:154-155,
  :228-229), taken chunk by chunk with a strict ``<`` across chunks; the
  analytic tier (``env_analytic``) instead projects onto the section's
  Douglas-Peucker line segments in the same loop;
* the force is accumulated straight into the tile's registers.

Two force kinds cover the four environment terms:

* ``exp``: magnitude ``a * exp(-d/b)`` away from the closest point -- the
  border force (forces.py:138-179) and the Helbing-1995 space-repulsive
  force (u0/r * exp(-d/r));
* ``moussaid``: the Moussaid interaction against the closest point with
  relative velocity -- static and dynamic obstacles (forces.py:182-283).

Equivalence to the jnp path is checked by tests/test_env_pallas.py in
interpret mode and by chip_smoke.py compiled on the card.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from .geometry import _PAD, _PAD_DIST2
from .pallas_forces import (_NUM_STAGES, _NUM_WARPS, _SENTINEL, _TINY,
                            _round_up)
from .spatial import morton_sort, tile_bboxes


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _closest(pt_refs, base, px, py, *, analytic, kc, n_chunks):
    """Closest point of one section to each pedestrian of the tile.

    ``pt_refs``: sampled (x, y) point planes, or analytic (ax, ay, ux, uy,
    inv_len2) segment planes, each section occupying ``kc * n_chunks``
    consecutive slots from ``base``.  Returns ``(dmin2, cx, cy)`` of shape
    (TP,) with first-occurrence tie-breaking over the section's slots.
    Padding slots sit at PAD_COORD and lose every comparison."""

    def chunk(c, best):
        start = pl.multiple_of(base + c * kc, kc)
        if analytic:
            ax, ay, ux, uy, il2 = (r[pl.ds(start, kc)][:, None]
                                   for r in pt_refs)
            t = jnp.clip(((px[None, :] - ax) * ux + (py[None, :] - ay) * uy)
                         * il2, 0.0, 1.0)
            cx = ax + t * ux                       # (kc, TP)
            cy = ay + t * uy
        else:
            cx, cy = (r[pl.ds(start, kc)][:, None] for r in pt_refs)
        ddx = px[None, :] - cx
        ddy = py[None, :] - cy
        d2 = ddx * ddx + ddy * ddy                 # (kc, TP)
        dmin = jnp.min(d2, axis=0)
        ids = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 0)
        first = jnp.min(jnp.where(d2 == dmin[None, :], ids, kc), axis=0)
        sel = ids == first[None, :]
        sx = jnp.sum(jnp.where(sel, cx, 0.0), axis=0)
        sy = jnp.sum(jnp.where(sel, cy, 0.0), axis=0)
        bd, bx, by = best
        better = dmin < bd                          # earlier chunk wins ties
        return (jnp.where(better, dmin, bd), jnp.where(better, sx, bx),
                jnp.where(better, sy, by))

    inf = jnp.full(px.shape, jnp.inf, jnp.float32)
    init = (inf, jnp.zeros_like(inf), jnp.zeros_like(inf))
    if n_chunks == 1:
        return chunk(0, init)
    return jax.lax.fori_loop(0, n_chunks, chunk, init)


def _exp_force(prm_ref, dmin, cx, cy, ok, px, py, prad, *, use_radius):
    """``a * exp(-d/b)`` away from the closest point (reference
    forces.py:154-165; the space-repulsive variant maps a = u0/r, b = r)."""
    r = jax.lax.rsqrt(dmin + _TINY)
    d = dmin * r
    if use_radius:
        d = d - prad
    mag = jnp.where(ok, (prm_ref[0] * jnp.exp(-d * prm_ref[1])) * r, 0.0)
    return mag * (px - cx), mag * (py - cy)


def _moussaid_force(prm_ref, dmin, cx, cy, ok, px, py, prad, pvx, pvy,
                    ovx, ovy, *, use_radius):
    """Moussaid interaction against the closest point with relative
    velocity v_ped - v_obstacle (reference forces.py:233-270); the same
    folding as ops/pallas_forces._pair_tile."""
    lam, A, gamma, n, n_prime, epsilon = (prm_ref[k] for k in range(6))
    dx = cx - px                           # ped -> obstacle point
    dy = cy - py
    r = jax.lax.rsqrt(dmin + _TINY)
    ex = dx * r
    ey = dy * r
    d = dmin * r
    if use_radius:
        d = d - prad
    tx = lam * (pvx - ovx) + ex
    ty = lam * (pvy - ovy) + ey
    t2 = tx * tx + ty * ty
    rt = jax.lax.rsqrt(t2 + _TINY)
    t_len = t2 * rt
    theta = (jnp.arctan2(tx * ey - ty * ex, ex * tx + ey * ty)
             + (-epsilon * gamma) * t_len)
    ok = ok & (dmin > 0.0)
    if use_radius:
        # d can be negative with radii subtracted while t2 == 0
        ok = ok & (t2 > 0.0)
    common = jnp.where(ok, d * rt * (-1.0 / gamma), -jnp.inf)
    u2 = jnp.square(t_len * theta)
    f_v = -A * jnp.exp(common - jnp.square(n_prime * gamma) * u2) * rt
    f_t = ((-A * jnp.sign(theta))
           * jnp.exp(common - jnp.square(n * gamma) * u2) * rt)
    return f_v * tx - f_t * ty, f_v * ty + f_t * tx


def _env_kernel(prm_ref, bb_ref, meta_ref, *refs, kind, analytic, n_seg,
                kc, n_chunks, use_radius):
    """One program per pedestrian tile: loop over the sections, skipping
    those whose filter circle misses the tile's bounding box.

    ``meta_ref`` rows: filter center x, y, radius^2 (-1 = never), and for
    ``kind="moussaid"`` the obstacle velocity x, y."""
    n_pt = 5 if analytic else 2
    pt_refs = refs[:n_pt]
    fx_ref, fy_ref = refs[-2:]
    peds = [r[...] for r in refs[n_pt:-2]]
    px, py, prad = peds[:3]
    j = pl.program_id(0)
    minx, maxx, miny, maxy = (bb_ref[k, j] for k in range(4))

    def section(s, acc):
        scx = meta_ref[0, s]
        scy = meta_ref[1, s]
        sr2 = meta_ref[2, s]
        gx = jnp.maximum(jnp.maximum(scx - maxx, minx - scx), 0.0)
        gy = jnp.maximum(jnp.maximum(scy - maxy, miny - scy), 0.0)

        def compute():
            dmin, cx, cy = _closest(pt_refs, s * (kc * n_chunks), px, py,
                                    analytic=analytic, kc=kc,
                                    n_chunks=n_chunks)
            fdx = scx - px
            fdy = scy - py
            ok = (fdx * fdx + fdy * fdy < sr2) & (dmin < _PAD_DIST2)
            if kind == "exp":
                fx, fy = _exp_force(prm_ref, dmin, cx, cy, ok, px, py, prad,
                                    use_radius=use_radius)
            else:
                fx, fy = _moussaid_force(
                    prm_ref, dmin, cx, cy, ok, px, py, prad, peds[3],
                    peds[4], meta_ref[3, s], meta_ref[4, s],
                    use_radius=use_radius)
            return acc[0] + fx, acc[1] + fy

        return jax.lax.cond(gx * gx + gy * gy <= sr2, compute, lambda: acc)

    zero = jnp.zeros(px.shape, jnp.float32)
    fx, fy = jax.lax.fori_loop(0, n_seg, section, (zero, zero))
    fx_ref[...] = fx
    fy_ref[...] = fy


def _env_force_call(kind, prm, pt_planes, meta, ped_planes, bb, *, n_seg,
                    kc, n_chunks, tp, use_radius, analytic, interpret):
    """One fused launch; returns (fx, fy) of shape (n_pad,)."""
    n_pad = ped_planes[0].shape[0]

    def whole(a):
        return pl.BlockSpec(a.shape, lambda j: (0,) * a.ndim)

    ped_spec = pl.BlockSpec((tp,), lambda j: (j,))
    kernel = functools.partial(
        _env_kernel, kind=kind, analytic=analytic, n_seg=n_seg, kc=kc,
        n_chunks=n_chunks, use_radius=use_radius)
    return pl.pallas_call(
        kernel,
        grid=(n_pad // tp,),
        in_specs=([whole(prm), whole(bb), whole(meta)]
                  + [whole(p) for p in pt_planes]
                  + [ped_spec] * len(ped_planes)),
        out_specs=(ped_spec, ped_spec),
        out_shape=(jax.ShapeDtypeStruct((n_pad,), jnp.float32),) * 2,
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=_NUM_WARPS,
                                            num_stages=_NUM_STAGES),
        interpret=interpret,
        name=f"env_force_{kind}",
    )(prm, bb, meta, *pt_planes, *ped_planes)


def _stage_points(sset, analytic: bool, point_chunk: int):
    """Section-major point (or segment) planes, each section padded to a
    whole number of power-of-two chunks.  Returns (planes, kc, n_chunks)."""
    s = sset.num_segments
    k = sset.max_segments if analytic else sset.points_per_segment
    kc = min(point_chunk, _next_pow2(k))
    k_pad = _round_up(k, kc)

    def plane(arr, fill):
        arr = arr.reshape(s, k).astype(jnp.float32)
        out = jnp.full((s, k_pad), jnp.float32(fill)).at[:, :k].set(arr)
        return out.reshape(-1)

    if analytic:
        planes = [plane(sset.ax, _PAD), plane(sset.ay, _PAD),
                  plane(sset.ux, 0.0), plane(sset.uy, 0.0),
                  plane(sset.inv_len2, 0.0)]
    else:
        planes = [plane(sset.points[..., 0], _PAD),
                  plane(sset.points[..., 1], _PAD)]
    return planes, kc, k_pad // kc


def fused_environment_terms(state, scene, params, veh_snap,
                            ped_tile: int = 32, point_tile: int = 128,
                            interpret: bool = False,
                            spatial_order: str = "hilbert",
                            analytic: bool = False):
    """Environment force terms via the fused kernels, keyed like
    models.stepper.force_terms.  Covers the terms whose section-major
    layout is available (models.stepper.prepare_scene); callers use the
    jnp path for the rest.

    ``ped_tile``: pedestrians per program (power of two).  ``point_tile``:
    sampled points per inner chunk (power of two; sections are padded to a
    whole number of chunks).

    One locality sort and staging is shared by all terms; each term
    unsorts only its final force planes.

    ``analytic`` (``StepConfig.env_analytic``): border-family forces use
    the line-segment geometry (``scene.borders_geom``, built by
    prepare_scene via env/pointsets.analytic_split) -- the closest point
    is computed ON the Douglas-Peucker-simplified segments instead of by
    argmin over the reference's 0.1 m point sampling.  Sections that do
    not simplify stay on the sampled path (``scene.borders_seg_rest``) and
    their term is added.  The deviation from the reference's sampled
    argmin is bounded by the sampling quantization itself.
    """
    from ..models import modes
    from ..models.vehicles import snapshot_segment_pointset

    if ped_tile < 1 or ped_tile & (ped_tile - 1):
        raise ValueError(f"env ped_tile must be a power of two, "
                         f"got {ped_tile}")
    # (name, kind, set, prm values, obstacle vel, active, use_radius,
    # analytic); "<term>#rest" sums into <term> (the sampled remainder of
    # an analytic split)
    jobs = []
    use_geom = analytic and getattr(scene, "borders_geom", None) is not None

    def border_jobs(name, prm_vals, use_rad):
        if use_geom:
            jobs.append((name, "exp", scene.borders_geom, prm_vals,
                         None, None, use_rad, True))
            if getattr(scene, "borders_seg_rest", None) is not None:
                jobs.append((name + "#rest", "exp", scene.borders_seg_rest,
                             prm_vals, None, None, use_rad, False))
        else:
            jobs.append((name, "exp", scene.borders_seg, prm_vals,
                         None, None, use_rad, False))

    if params.enable_border and scene.borders_seg is not None:
        b = params.border
        border_jobs("border_force", (b.a, 1.0 / b.b), params.use_ped_radius)
    if params.enable_space_repulsive and scene.borders_seg is not None:
        sp = params.space_repulsive
        border_jobs("space_repulsive_force", (sp.u0 / sp.r, 1.0 / sp.r),
                    False)
    if (params.enable_static_obstacle
            and scene.static_obstacles_seg is not None):
        p = params.static_obstacle
        jobs.append(("static_obstacle_force", "moussaid",
                     scene.static_obstacles_seg,
                     (p.lambda_, p.A, p.gamma, p.n, p.n_prime, p.epsilon),
                     scene.static_obstacle_vel, None, params.use_ped_radius,
                     False))
    if params.enable_dynamic_obstacle and veh_snap is not None:
        p = params.dynamic_obstacle
        dset, dvel, dact = snapshot_segment_pointset(
            veh_snap, p.perception_threshold)
        jobs.append(("dynamic_obstacle_force", "moussaid", dset,
                     (p.lambda_, p.A, p.gamma, p.n, p.n_prime, p.epsilon),
                     dvel, dact, params.use_ped_radius, False))
    if not jobs:
        return {}

    alive = state.alive
    n = state.pos_x.shape[0]
    tp = ped_tile
    n_pad = _round_up(max(n, tp), tp)

    (spx, spy, svx, svy, srad, salive), inv = morton_sort(
        (state.pos_x, state.pos_y), alive,
        (state.pos_x, state.pos_y, state.vel_x, state.vel_y, state.radius,
         alive), order=spatial_order)

    def lane(a, fill):
        a = jnp.where(salive, a.astype(jnp.float32), jnp.float32(fill))
        return jnp.full((n_pad,), jnp.float32(fill)).at[:n].set(a)

    px, py = lane(spx, _SENTINEL), lane(spy, _SENTINEL)
    pvx, pvy, prad = lane(svx, 0.0), lane(svy, 0.0), lane(srad, 0.0)
    alive_pad = jnp.zeros((n_pad,), bool).at[:n].set(salive)
    bb = tile_bboxes(px, py, alive_pad, tp).T      # (4, n_tiles)
    crossing = ((state.mode == modes.CROSSING_ROAD)
                | (state.mode == modes.ROAD_TO_SIDEWALK))

    terms = {}
    for (name, kind, sset, prm_vals, obs_vel, active, use_radius,
         is_analytic) in jobs:
        s = sset.num_segments
        pts, kc, n_chunks = _stage_points(sset, is_analytic, point_tile)
        r2 = jnp.square(jnp.maximum(sset.filter_radius, 0.0))
        if active is not None:
            r2 = jnp.where(active, r2, -1.0)
        meta = [sset.centers[:, 0], sset.centers[:, 1], r2]
        ped_planes = [px, py, prad]
        if kind == "moussaid":
            ov = (obs_vel if obs_vel is not None
                  else jnp.zeros((s, 2), jnp.float32))
            meta += [ov[:, 0], ov[:, 1]]
            ped_planes += [pvx, pvy]
        meta = jnp.stack([m.astype(jnp.float32) for m in meta])
        prm = jnp.stack([jnp.asarray(v, jnp.float32) for v in prm_vals])
        fx, fy = _env_force_call(
            kind, prm, pts, meta, ped_planes, bb, n_seg=s, kc=kc,
            n_chunks=n_chunks, tp=tp, use_radius=use_radius,
            analytic=is_analytic, interpret=interpret)

        dtype = state.pos_x.dtype
        ux = fx[:n][inv].astype(dtype)
        uy = fy[:n][inv].astype(dtype)
        if kind == "exp":
            # border/space forces are disabled for crossing pedestrians
            # (reference forces.py:176-177)
            ux = jnp.where(crossing, 0.0, ux)
            uy = jnp.where(crossing, 0.0, uy)
        base = name.split("#")[0]
        if base in terms:
            tx, ty = terms[base]
            terms[base] = (tx + ux, ty + uy)
        else:
            terms[base] = (ux, uy)
    return terms

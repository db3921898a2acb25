"""Fused Pallas kernels (Triton route, GPU) for the N x N pair forces.

Three model families share one launch (:func:`_tile_fn`): ``law=
"moussaid"`` (the reference's force), ``law="powerlaw"`` (Karamouzas et
al. 2014 time-to-collision) and ``law="helbing"`` (Helbing-Molnar 1995
elliptical repulsion with field-of-view).

The jnp formulation (ops/forces.pedestrian_force) is a ``lax.map`` over
row blocks that builds several ``(row_block, N)`` pairwise planes per
block.  The pair math is ~40 flops and 5 transcendentals per pair on ~20
bytes of agent state, so a kernel that keeps the pairwise temporaries in
registers is bound by the ALU/SFU, not by memory.

Kernel layout (designed for a GPU, not carried over from a sequential
grid):

* one program per row tile; the row tile's state stays in registers as
  ``(TR, 1)`` columns, and each program writes its own rows (no atomics,
  so results are deterministic);
* an in-kernel ``fori_loop`` walks the column tiles, loading ``(1, TC)``
  rows of the x/y/vx/vy/r planes and reducing each ``(TR, TC)`` pair
  block into the row accumulators;
* with an interaction ``cutoff`` the wrapper computes every tile's
  bounding box and, per row tile, the ascending list of column tiles
  within the cutoff; each program walks only its list.  When a list would
  overflow its width (or there are few column tiles) the loop instead
  tests each column tile's box, loaded by the block, and skips the far
  ones -- the two launches sum the same tiles, in ascending order.  With
  the locality sort of :func:`pedestrian_force_pallas_sorted` the cutoff
  kernel is O(N) at fixed density; the per-pair cutoff keeps the result
  independent of the tile layout.

Dead and padded agents are staged at a far sentinel so their pair terms
underflow to exactly zero with no per-pair masking.  Semantics match
ops/forces (same masking rule, same zero guards); tests compare the two
in interpret mode, and chip_smoke.py compares them compiled on the card.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltr

from ..models.params import MoussaidParams


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


#: smaller than any squared pedestrian distance of interest, large enough
#: that rsqrt stays finite in f32 -- replaces where(x==0) guards
_TINY = 1e-35

#: parking position for dead/padded agents: far enough that every mixed
#: dead-alive pair's exp underflows to exactly +0, small enough that squared
#: sentinel-sentinel distances stay finite in f32
_SENTINEL = 1.0e7

#: warps per program and software-pipeline stages (Triton CompilerParams);
#: tools/kernel_probe.py ``warps`` times the alternatives (PERF.md)
_NUM_WARPS = 4
_NUM_STAGES = 1

#: survivor-list width of the compacted cutoff launch: row tiles list up to
#: this many column tiles within the cutoff; the launch engages above
#: twice as many column tiles and falls back to the in-loop skip when a
#: row tile has more survivors
_MAX_SURV = 128


def _pair_tile(xi, yi, vxi, vyi, rad_r, xj, yj, vxj, vyj, rad_c, *,
               lam, A, gamma, n, n_prime, epsilon, use_radius, cutoff):
    """Moussaid (2009) pair block: ``(TR, 1)`` rows x ``(1, TC)`` columns
    -> ``(fx, fy)`` of shape (TR, TC) (force on row agent i from j)."""
    dx = xj - xi                       # x_j - x_i
    dy = yj - yi
    d2 = dx * dx + dy * dy
    r = jax.lax.rsqrt(d2 + _TINY)
    ex = dx * r
    ey = dy * r
    d = d2 * r
    if use_radius:
        d = d - (rad_r + rad_c)

    dvx = vxi - vxj                    # v_i - v_j
    dvy = vyi - vyj
    tx = lam * dvx + ex
    ty = lam * dvy + ey
    t2 = tx * tx + ty * ty
    rt = jax.lax.rsqrt(t2 + _TINY)
    t_len = t2 * rt

    # theta from the *unnormalized* t (atan2 is scale-invariant); B =
    # gamma*t_len is never materialized: the evasion shift folds into the
    # -epsilon*gamma scalar and the Gaussian widths into (n*gamma)^2 /
    # (n_prime*gamma)^2 applied to u^2 = (t_len*theta)^2
    cross = tx * ey - ty * ex
    dot = ex * tx + ey * ty
    theta = jnp.arctan2(cross, dot) + (-epsilon * gamma) * t_len

    # coincident pairs (self, dead-dead sentinels, exactly coincident live
    # agents -- NaN in the reference, zero here) are exactly d2 == 0;
    # dead-live pairs underflow through the sentinel distance, and B == 0
    # drives common to -inf through rt = rsqrt(tiny)
    ok = d2 > 0.0
    if use_radius:
        # with radii subtracted d can be negative while t2 == 0: mask
        # B > 0 explicitly (exp(+inf) * 0 would be NaN)
        ok = ok & (t2 > 0.0)
    if cutoff is not None:
        ok = ok & (d2 <= cutoff * cutoff)

    common = jnp.where(ok, d * rt * (-1.0 / gamma), -jnp.inf)
    u2 = jnp.square(t_len * theta)
    f_v = -A * jnp.exp(common - jnp.square(n_prime * gamma) * u2)
    # sign(theta) must be exact (sign(0) = 0): with epsilon = 0 every
    # equal-velocity pair has theta == 0 and the reference emits no
    # tangential force there
    f_t = (-A * jnp.sign(theta)) * jnp.exp(common - jnp.square(n * gamma) * u2)
    # f = f_v * t_hat + f_t * left_normal(t_hat), 1/|t| folded in
    f_v = f_v * rt
    f_t = f_t * rt
    return f_v * tx - f_t * ty, f_v * ty + f_t * tx


def _pair_tile_powerlaw(xi, yi, vxi, vyi, rad_r, xj, yj, vxj, vyj, rad_c, *,
                        k, tau0, tau_max, tau_min, use_radius, cutoff):
    """Karamouzas et al. (2014) time-to-collision pair block (see
    ops/forces._powerlaw_pair_force).  Disc radii always participate;
    ``use_radius`` is accepted for signature parity.  Dead/padded
    sentinels mask through tau > tau_max (live-dead) and c <= 0 with zero
    staged radii (dead-dead, self, coincident)."""
    del use_radius
    xx = xi - xj                       # x_i - x_j
    xy = yi - yj
    vx = vxi - vxj                     # v_i - v_j
    vy = vyi - vyj
    rsum = rad_r + rad_c
    a = vx * vx + vy * vy
    b = xx * vx + xy * vy
    d2 = xx * xx + xy * xy
    c = d2 - rsum * rsum
    disc = b * b - a * c
    ok = (c > 0.0) & (disc > 0.0) & (a > 1e-8)
    if cutoff is not None:
        ok = ok & (d2 <= cutoff * cutoff)

    rs = jax.lax.rsqrt(jnp.where(ok, disc, 1.0))
    s = disc * rs                      # sqrt(disc), 0-safe via the mask
    a_safe = jnp.where(ok, a, 1.0)
    ra = 1.0 / a_safe
    tau = (-b - s) * ra
    ok = ok & (tau > 0.0) & (tau < tau_max)
    tau = jnp.clip(tau, tau_min, tau_max)
    rtau = 1.0 / tau
    inv_tau0 = 1.0 / tau0
    mag = (k * jnp.exp(-tau * inv_tau0)) * ((2.0 * rtau + inv_tau0)
                                            * (rtau * rtau))
    scale = jnp.where(ok, mag * ra * rs, 0.0)
    sb = s + b
    return scale * (a * xx - sb * vx), scale * (a * xy - sb * vy)


def _pair_tile_helbing(xi, yi, exi, eyi, rad_r, xj, yj, vxj, vyj, rad_c, *,
                       v0, sigma, cos_phi, fov_factor, dt_w, b_min,
                       use_radius, cutoff):
    """Helbing-Molnar (1995) elliptical-repulsion pair block (see
    ops/forces.ped_repulsive_force).  The law reads the partner's velocity
    but never the pedestrian's own, and needs the pedestrian's desired
    direction ``e_i`` for the field-of-view weight -- so the ROW velocity
    planes carry ``e_i`` (staged by :func:`pedestrian_force_pallas`
    ``desired=...``) while the column planes carry the real ``v_j``."""
    del use_radius, rad_r, rad_c
    dx = xi - xj                       # d = r_i - r_j
    dy = yi - yj
    yx = dt_w * vxj                    # partner's anticipated step
    yy = dt_w * vyj
    mx = dx - yx                       # d - y
    my = dy - yy
    d2 = dx * dx + dy * dy
    m2 = mx * mx + my * my
    rd = jax.lax.rsqrt(d2 + _TINY)
    rm = jax.lax.rsqrt(m2 + _TINY)
    s = d2 * rd + m2 * rm
    y2 = yx * yx + yy * yy
    b2 = jnp.maximum(s * s - y2, 0.0) * 0.25
    rb = jax.lax.rsqrt(b2 + _TINY)
    b = b2 * rb                        # ellipse semi-minor axis

    # self/coincident/dead-dead pairs (d2 == 0) and degenerate geometry
    # (b == 0) are masked, matching ops/forces.ped_repulsive_force;
    # dead-live pairs underflow through the sentinel distance
    ok = (d2 > 0.0) & (m2 > 0.0) & (b2 > 0.0)
    if cutoff is not None:
        ok = ok & (d2 <= cutoff * cutoff)

    # b_min floor (PedRepulsiveParams.b_min): 1/max(b, b_min) reuses rb
    bc = jnp.maximum(b, b_min)
    rbc = jnp.minimum(rb, 1.0 / b_min)
    gx = dx * rd + mx * rm
    gy = dy * rd + my * rm
    mag = jnp.where(ok, (v0 / sigma) * jnp.exp(-bc * (1.0 / sigma))
                    * (0.25 * s * rbc), 0.0)

    # field-of-view modulation (Helbing eq. 7): -f and -grad are positive
    # multiples, so the test uses grad directly
    g2 = gx * gx + gy * gy
    gn = g2 * jax.lax.rsqrt(g2 + _TINY)
    seen = -(exi * gx + eyi * gy) >= gn * cos_phi
    w = jnp.where(seen, mag, fov_factor * mag)
    return w * gx, w * gy


def _tile_fn(law, prm_ref, **kw):
    """Bind the per-law pair block to its parameters (loaded from the
    ``prm`` vector, so they may be traced -- vmapped parameter sweeps keep
    the kernel).  A new pair law needs a block function here and a
    :func:`_params_vec` entry."""
    if law == "powerlaw":
        return functools.partial(
            _pair_tile_powerlaw, k=prm_ref[0], tau0=prm_ref[1],
            tau_max=prm_ref[2], tau_min=prm_ref[3], **kw)
    if law == "helbing":
        return functools.partial(
            _pair_tile_helbing, v0=prm_ref[0], sigma=prm_ref[1],
            cos_phi=prm_ref[2], fov_factor=prm_ref[3], dt_w=prm_ref[4],
            b_min=prm_ref[5], **kw)
    return functools.partial(
        _pair_tile, lam=prm_ref[0], A=prm_ref[1], gamma=prm_ref[2],
        n=prm_ref[3], n_prime=prm_ref[4], epsilon=prm_ref[5], **kw)


def _pair_kernel(prm_ref, rbb_ref, cbb_ref, *refs, law, tc, n_col_tiles,
                 use_radius, cutoff, compact):
    """One row-tile program: loop over the column tiles, accumulating the
    row forces in registers.

    ``compact``: two leading refs carry the survivor list ``(R, W)`` and
    count ``(R,)``; the program walks the row tile's surviving column
    tiles instead of testing every tile's bounding box."""
    if compact:
        surv_ref, cnt_ref, *refs = refs
    (rx_ref, ry_ref, rvx_ref, rvy_ref, rrad_ref,
     cx_ref, cy_ref, cvx_ref, cvy_ref, crad_ref, fx_ref, fy_ref) = refs
    i = pl.program_id(0)
    rows = [r[...][:, None] for r in (rx_ref, ry_ref, rvx_ref, rvy_ref,
                                      rrad_ref)]
    tile = _tile_fn(law, prm_ref, use_radius=use_radius, cutoff=cutoff)
    zero = jnp.zeros(rx_ref.shape, jnp.float32)

    def tile_sum(j, acc):
        start = pl.multiple_of(j * tc, tc)
        cols = [c[pl.ds(start, tc)][None, :]
                for c in (cx_ref, cy_ref, cvx_ref, cvy_ref, crad_ref)]
        fx, fy = tile(*rows, *cols)
        return acc[0] + jnp.sum(fx, axis=1), acc[1] + jnp.sum(fy, axis=1)

    if compact:
        fx, fy = jax.lax.fori_loop(
            0, cnt_ref[i], lambda jj, acc: tile_sum(surv_ref[i, jj], acc),
            (zero, zero))
    else:
        step = tile_sum
        if cutoff is not None:
            # tile bboxes ride as (4, n_tiles) planes: minx, maxx, miny,
            # maxy; empty tiles carry inverted infinite boxes, always skip
            rminx, rmaxx, rminy, rmaxy = (rbb_ref[k, i] for k in range(4))

            def step(j, acc):
                gx = jnp.maximum(jnp.maximum(cbb_ref[0, j] - rmaxx,
                                             rminx - cbb_ref[1, j]), 0.0)
                gy = jnp.maximum(jnp.maximum(cbb_ref[2, j] - rmaxy,
                                             rminy - cbb_ref[3, j]), 0.0)
                return jax.lax.cond(gx * gx + gy * gy <= cutoff * cutoff,
                                    lambda: tile_sum(j, acc), lambda: acc)

        fx, fy = jax.lax.fori_loop(0, n_col_tiles, step, (zero, zero))
    fx_ref[...] = fx
    fy_ref[...] = fy


def _slab_call(prm, row_planes, row_bb, col_planes, col_bb, *, law, tr, tc,
               use_radius, cutoff, interpret, surv=None):
    """One launch over a (n_rows x n_cols) slab of staged state; returns
    the ``(fx, fy)`` row sums, shape (n_rows,) each.  ``surv``: optional
    ``(survivor list, count)`` of the compacted cutoff launch."""
    n_rows = row_planes[0].shape[0]

    def whole(a):
        return pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)

    row_spec = pl.BlockSpec((tr,), lambda i: (i,))
    kernel = functools.partial(
        _pair_kernel, law=law, tc=tc,
        n_col_tiles=col_planes[0].shape[0] // tc, use_radius=use_radius,
        cutoff=float(cutoff) if cutoff is not None else None,
        compact=surv is not None)
    extra = list(surv) if surv is not None else []
    return pl.pallas_call(
        kernel,
        grid=(n_rows // tr,),
        in_specs=([whole(prm), whole(row_bb), whole(col_bb)]
                  + [whole(a) for a in extra]
                  + [row_spec] * 5 + [whole(c) for c in col_planes]),
        out_specs=(row_spec, row_spec),
        out_shape=(jax.ShapeDtypeStruct((n_rows,), jnp.float32),) * 2,
        backend="triton",
        compiler_params=pltr.CompilerParams(num_warps=_NUM_WARPS,
                                            num_stages=_NUM_STAGES),
        interpret=interpret,
        name=f"pair_force_{law}",
    )(prm, row_bb, col_bb, *extra, *row_planes, *col_planes)


def pedestrian_force_pallas(pos, vel, radius, alive, p: MoussaidParams,
                            use_ped_radius: bool = False, row_tile: int = 32,
                            col_tile: int = 32, interpret: bool = False,
                            axis_name: str | None = None,
                            cutoff: float | None = None,
                            axis_comm: str = "gather",
                            planar_out: bool = False,
                            law: str = "moussaid",
                            desired=None):
    """Drop-in replacement for ops.forces.pedestrian_force (and its
    power-law / Helbing twins through ``law``).

    ``law``: ``"moussaid"`` (default), ``"powerlaw"`` (``p`` is a
    PowerLawParams; disc radii always participate) or ``"helbing"`` (``p``
    is a PedRepulsiveParams and ``desired`` -- planar ``(ex, ey)`` unit
    desired directions -- is required).

    Force parameters enter the kernel as a small array, so ``p``'s leaves
    may be traced (parameter sweeps vmap over them); only ``cutoff`` and
    ``use_ped_radius`` are compile-time.

    ``row_tile``/``col_tile`` must be powers of two (Triton block shapes).

    With ``axis_name`` (under shard_map, rows sharded over that mesh axis)
    the column state is communicated per ``axis_comm``:

    * ``"gather"``: all-gather the full column state, one launch over the
      (local rows x global cols) slab;
    * ``"ring"``: rotate one shard-sized column block around the ring
      with ``ppermute`` and accumulate partial forces block by block --
      peak memory O(N/devices), and the next block's transfer overlaps
      this block's kernel.

    ``cutoff`` (meters): pairs farther apart contribute zero and column
    tiles whose bounding boxes are farther than the cutoff from the row
    tile are never computed (survivor lists above 2 * _MAX_SURV column
    tiles, the in-loop skip below or on overflow; the ring path always
    skips in the loop).  Combine with the locality sort
    (:func:`pedestrian_force_pallas_sorted`) for tight boxes.  A cutoff
    >= 110 * gamma * (2*lambda*v_max + 1) is f32-exact (the skipped exp
    underflows to +0); smaller values truncate the interaction range.

    Dead/padded agents are staged at a far sentinel; positions must stay
    below ~1e6 m in magnitude.
    """
    from .vecmath import split_xy
    for t in (row_tile, col_tile):
        if t < 1 or t & (t - 1):
            raise ValueError(f"pair-kernel tiles must be powers of two, "
                             f"got {row_tile}x{col_tile}")
    if axis_name is not None and axis_comm not in ("gather", "ring"):
        raise ValueError(f"axis_comm must be 'gather' or 'ring', "
                         f"got {axis_comm!r}")
    px, py = split_xy(pos)
    vx, vy = split_xy(vel)
    n = px.shape[0]
    tr, tc = row_tile, col_tile

    if law == "helbing":
        if desired is None:
            raise ValueError("law='helbing' needs desired=(ex, ey) planes "
                             "(the FoV modulation reads the desired "
                             "direction; see _pair_tile_helbing)")
        row_vx, row_vy = desired
    elif desired is not None:
        raise ValueError(f"desired planes only apply to law='helbing', "
                         f"got law={law!r}")
    else:
        row_vx, row_vy = vx, vy

    n_rows = _round_up(max(n, tr), tr)
    rows = _stage(px, py, row_vx, row_vy, radius, alive, n_rows)
    row_bb = _bboxes(rows, alive, n, tr)
    prm = _params_vec(p, law)
    call = functools.partial(_slab_call, prm, rows, row_bb, law=law, tr=tr,
                             tc=tc, use_radius=use_ped_radius, cutoff=cutoff,
                             interpret=interpret)

    if axis_name is not None and axis_comm == "ring":
        n_dev = jax.lax.psum(1, axis_name)
        perm = [(d, (d - 1) % n_dev) for d in range(n_dev)]
        cols = _stage(px, py, vx, vy, radius, alive,
                      _round_up(max(n, 1), tc))
        blk = (jnp.stack(cols), _bboxes(cols, alive, n, tc))

        def step(carry, _):
            fx, fy, blk = carry
            # issue the permute before the kernel so the next block's
            # transfer overlaps this block's compute
            nxt = jax.tree_util.tree_map(
                lambda a: jax.lax.ppermute(a, axis_name, perm), blk)
            fxp, fyp = call(list(blk[0]), blk[1])
            return (fx + fxp, fy + fyp, nxt), None

        zero = jnp.zeros((n_rows,), jnp.float32)
        (fx, fy, _), _ = jax.lax.scan(step, (zero, zero, blk),
                                      jnp.arange(n_dev))
    else:
        if axis_name is not None:
            g = lambda a: jax.lax.all_gather(a, axis_name, tiled=True)  # noqa: E731
            cpx, cpy, cvx, cvy, crad, calive = (
                g(px), g(py), g(vx), g(vy), g(radius), g(alive))
        else:
            cpx, cpy, cvx, cvy, crad, calive = px, py, vx, vy, radius, alive
        n_c = cpx.shape[0]
        n_cols = _round_up(max(n_c, 1), tc)
        cols = _stage(cpx, cpy, cvx, cvy, crad, calive, n_cols)
        col_bb = _bboxes(cols, calive, n_c, tc)
        dense = functools.partial(call, cols, col_bb)
        width = _list_width(n_cols // tc)
        if cutoff is not None and width:
            # compacted launch: each row tile walks only its surviving
            # column tiles (ascending, so the sum order matches the
            # in-loop skip); a row tile with more survivors than the list
            # holds sends the step to the in-loop skip
            from .spatial import surv_table
            hits = _bbox_hits(row_bb, col_bb, float(cutoff))
            surv, fits = surv_table(hits, width)
            cnt = jnp.sum(hits, axis=1, dtype=jnp.int32)
            fx, fy = jax.lax.cond(
                fits, lambda: call(cols, col_bb, surv=(surv, cnt)), dense)
        else:
            fx, fy = dense()

    fx = fx[:n].astype(px.dtype)
    fy = fy[:n].astype(py.dtype)
    if planar_out:
        return fx, fy
    return jnp.stack([fx, fy], axis=-1)


def _list_width(n_col_tiles: int) -> int:
    """Survivor-list width of the compacted cutoff launch over
    ``n_col_tiles`` column tiles; 0 where the list does not engage."""
    width = min(_MAX_SURV, n_col_tiles)
    return width if n_col_tiles > 2 * width else 0


def survivor_counts(pos, alive, cutoff: float, row_tile: int = 32,
                    col_tile: int = 32, spatial_order: str = "hilbert",
                    axis_name: str | None = None):
    """``(counts, width)`` of the survivor lists that
    :func:`pedestrian_force_pallas_sorted` (``axis_comm="gather"`` under
    ``axis_name``) builds for this layout: per local row tile the number of
    column tiles within ``cutoff``, and the list width.  The lists run iff
    ``width > 0`` and every count <= width; otherwise the in-loop skip runs.
    A diagnostic for tests and chip_smoke.py."""
    from .spatial import morton_sort
    from .vecmath import split_xy
    px, py = split_xy(pos)
    (sx, sy, sa), _ = morton_sort((px, py), alive, (px, py, alive),
                                  order=spatial_order)
    n = sx.shape[0]
    n_rows = _round_up(max(n, row_tile), row_tile)
    row_bb = _bboxes(_stage(sx, sy, sx, sx, sx, sa, n_rows), sa, n, row_tile)
    if axis_name is not None:
        sx, sy, sa = (jax.lax.all_gather(a, axis_name, tiled=True)
                      for a in (sx, sy, sa))
    n_c = sx.shape[0]
    n_cols = _round_up(max(n_c, 1), col_tile)
    col_bb = _bboxes(_stage(sx, sy, sx, sx, sx, sa, n_cols), sa, n_c,
                     col_tile)
    hits = _bbox_hits(row_bb, col_bb, float(cutoff))
    return (jnp.sum(hits, axis=1, dtype=jnp.int32),
            _list_width(n_cols // col_tile))


def _bbox_hits(row_bb, col_bb, cutoff: float):
    """(R, C) bool: is the gap between row tile i's and column tile j's
    bounding boxes within the cutoff?  The jnp twin of the in-kernel test
    (same (4, n_tiles) boxes; empty tiles never hit)."""
    gx = jnp.maximum(jnp.maximum(col_bb[0][None, :] - row_bb[1][:, None],
                                 row_bb[0][:, None] - col_bb[1][None, :]),
                     0.0)
    gy = jnp.maximum(jnp.maximum(col_bb[2][None, :] - row_bb[3][:, None],
                                 row_bb[2][:, None] - col_bb[3][None, :]),
                     0.0)
    return gx * gx + gy * gy <= cutoff * cutoff


def _stage(px, py, vx, vy, rad, ok, width):
    """Pad to ``width``; dead/padded agents at the sentinel, zero vel."""
    cnt = px.shape[0]
    out = []
    for a, fill in ((px, _SENTINEL), (py, _SENTINEL), (vx, 0.0),
                    (vy, 0.0), (rad, 0.0)):
        a = jnp.where(ok, a.astype(jnp.float32), jnp.float32(fill))
        out.append(jnp.full((width,), jnp.float32(fill)).at[:cnt].set(a))
    return out


def _bboxes(staged, alive, count, tile):
    """(4, n_tiles) tile bounding boxes (minx, maxx, miny, maxy rows) of
    the alive agents in the staged planes."""
    from .spatial import tile_bboxes
    width = staged[0].shape[0]
    mask = jnp.zeros((width,), bool).at[:count].set(alive)
    return tile_bboxes(staged[0], staged[1], mask, tile).T


def _params_vec(p, law: str = "moussaid") -> jnp.ndarray:
    """Force-parameter vector for the given pair law, padded to 8 entries;
    leaves may be traced (parameter sweeps vmap over them)."""
    if law == "powerlaw":
        vals = (p.k, p.tau0, p.tau_max, p.tau_min)
    elif law == "helbing":
        vals = (p.v0, p.sigma, jnp.cos(jnp.deg2rad(p.fov_phi)),
                p.fov_factor, p.step_width, p.b_min)
    else:
        vals = (p.lambda_, p.A, p.gamma, p.n, p.n_prime, p.epsilon)
    vals = [jnp.asarray(v, jnp.float32) for v in vals]
    vals += [jnp.zeros_like(vals[0])] * (8 - len(vals))
    return jnp.stack(vals, axis=-1)


def pedestrian_force_pallas_sorted(pos, vel, radius, alive, p: MoussaidParams,
                                   cutoff: float,
                                   use_ped_radius: bool = False,
                                   row_tile: int = 32, col_tile: int = 32,
                                   interpret: bool = False,
                                   axis_name: str | None = None,
                                   axis_comm: str = "ring",
                                   planar_out: bool = False,
                                   spatial_order: str = "hilbert",
                                   law: str = "moussaid",
                                   desired=None):
    """Locality-sorted cutoff kernel: sort agents along a space-filling
    curve so kernel tiles are spatially tight, run the cutoff kernel,
    scatter the forces back to the original slot order.  Equals the
    unsorted cutoff kernel up to f32 summation order.

    ``spatial_order``: ``"hilbert"`` (default; no Z-jumps, so tighter
    tile boxes and more skipped tiles) or ``"morton"`` (Z-order).

    Under agent-sharding (``axis_name``) each device sorts its *local*
    shard; the per-pair cutoff keeps the result exact regardless of the
    global layout, and the rotated per-tile bounding boxes let spatially
    distant shard pairs skip all their tiles."""
    from .spatial import morton_sort
    from .vecmath import split_xy
    px, py = split_xy(pos)
    vx, vy = split_xy(vel)
    operands = [px, py, vx, vy, radius, alive]
    if desired is not None:
        operands += list(desired)
    sorted_ops, inv = morton_sort((px, py), alive, tuple(operands),
                                  order=spatial_order)
    spx, spy, svx, svy, srad, salive = sorted_ops[:6]
    sdesired = tuple(sorted_ops[6:]) if desired is not None else None
    force = pedestrian_force_pallas(
        (spx, spy), (svx, svy), srad, salive, p,
        use_ped_radius=use_ped_radius, row_tile=row_tile, col_tile=col_tile,
        interpret=interpret, cutoff=cutoff, axis_name=axis_name,
        axis_comm=axis_comm, planar_out=planar_out, law=law,
        desired=sdesired)
    if planar_out:
        fx, fy = force
        return fx[inv], fy[inv]
    return force[inv]

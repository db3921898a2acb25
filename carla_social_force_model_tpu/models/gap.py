"""Vectorized gap-acceptance road-crossing check.

Branchless jnp replacement for the reference's Shapely-based
``check_traffic`` (/root/reference/check_traffic.py:7-61): a pedestrian in
CHECKING_TRAFFIC may start crossing unless any moving vehicle's swept segment
(back -> front + v * (t_ped + margin)) intersects the pedestrian's crossing
segment with a time-to-intersection conflict.

The reference applies the *first* vehicle's (x, y) extent elementwise to all
vehicles' direction vectors (``vehicle_extents[:][0]``, check_traffic.py:35-36);
the physically-correct per-vehicle longitudinal extent is used by default and
the quirk is reproduced under ``strict_parity``.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops.geometry import segment_intersection_xy
from ..ops import vecmath


def gap_ready(pos, goal, crossing_speed, margin,
              veh_center, veh_vel, veh_extent, veh_active,
              strict_parity: bool = False):
    """Per-pedestrian readiness to cross.

    Args:
      pos, goal: crossing segment endpoints (current loc -> waypoint) as
        (N, 2) arrays or (x, y) plane tuples -- all (N, V)-shaped work is
        planar (x/y planes, models/state.py).
      crossing_speed, margin: (N,).
      veh_center, veh_vel: (V, 2); veh_extent: (V, 2) bbox half extents;
      veh_active: (V,) bool.

    Returns (N,) bool; peds with negative margin always cross
    (check_traffic.py:23-24).
    """
    px, py = vecmath.split_xy(pos)
    gx, gy = vecmath.split_xy(goal)
    speed_safe = jnp.where(crossing_speed == 0.0, 1.0, crossing_speed)
    t_ped = vecmath.norm_xy(gx - px, gy - py) / speed_safe       # (N,)

    veh_dir, veh_speed = vecmath.normalize(veh_vel)              # (V,2),(V,)
    if strict_parity:
        offset = veh_dir * veh_extent[0][None, :]                # quirk
    else:
        offset = veh_dir * veh_extent[:, 0:1]                    # longitudinal
    front = veh_center + offset                                  # (V, 2)
    back = veh_center - offset

    # vehicle goal depends on the pedestrian's crossing time -> (N, V) planes
    horizon = (t_ped + margin)[:, None]
    veh_goal_x = front[None, :, 0] + veh_vel[None, :, 0] * horizon
    veh_goal_y = front[None, :, 1] + veh_vel[None, :, 1] * horizon

    hit, ipx, ipy = segment_intersection_xy(
        px[:, None], py[:, None], gx[:, None], gy[:, None],
        back[None, :, 0], back[None, :, 1], veh_goal_x, veh_goal_y)

    tti_ped = (vecmath.norm_xy(ipx - px[:, None], ipy - py[:, None])
               / speed_safe[:, None])
    vs_safe = jnp.where(veh_speed == 0.0, 1.0, veh_speed)[None, :]
    tti_front = vecmath.norm_xy(ipx - front[None, :, 0],
                                ipy - front[None, :, 1]) / vs_safe
    tti_back = vecmath.norm_xy(ipx - back[None, :, 0],
                               ipy - back[None, :, 1]) / vs_safe

    blocked = (hit & veh_active[None, :] & (veh_speed[None, :] != 0.0)
               & (tti_front - margin[:, None] < tti_ped)
               & (tti_ped < tti_back + margin[:, None]))
    return (margin < 0.0) | ~jnp.any(blocked, axis=1)
